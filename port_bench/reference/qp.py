"""The reference SQP-RTI tick and the judge of the program's ticks.

One RTI tick takes the warm start (xbar, ubar) it starts from, the
measured state x0, the obstacle parameters and bounds, and returns
(xbar + dx, ubar + du), where (dx, du) solves the QP that the OCP's
Gauss-Newton linearization at the warm start defines (acados' SQP_RTI with
a LINEAR_LS cost and exact RK4 shooting):

    min  sum_k<N  1/2 dx'Qc dx + du'Sc dx + 1/2 du'Rc du + qx'dx + qu'du
         + 1/2 dxN'QN dxN + qxN'dxN + sum of the soft rows' slack costs
    s.t. dx_0 = x0 - xbar_0,  dx_k+1 = A_k dx_k + B_k du_k + c_k,
         control boxes on every stage, hard state boxes on stages 1..N-1,
         hard distance rows lh <= h + C dx <= uh on stages 1..N-1, soft
         distance rows on stages 0..N-1 with slacks sl >= lsh, su >= ush.

(The program also carries the hard rows of stage 0; they do not depend on
the decision variables, so they change no optimum of a feasible QP.)

Here the linearization is worked out again in float64 (RK4 and its
Jacobians by `torch.func.jacfwd`), the dynamics are eliminated (dense
condensing in the controls) and the QP is solved by a dense primal-dual
interior point with Mehrotra's predictor-corrector, the slacks of the
soft rows eliminated by their Schur complement, to a complementarity of
1e-12.  The judge then reads, for each of the program's answers:

- `feas`: its largest violation of the QP's constraints, in the units of
  the states and rows (the dynamics and pinning residuals, the hard
  boxes and rows);
- `cost_gap`: |J(answer) - J(optimum)|, both evaluated on the same
  stage-wise objective, each answer with its best slacks.

The control is the same reference with its linearization rounded to
TF32 (`precision.tf32`), the QP then solved exactly: what the tick
produces when its linearization and assembly run in TF32.
"""

import torch

from port_bench.reference.precision import tf32
from port_bench.vendor.usv_models import OCPS

F64 = torch.float64


def _amax(x, dims):
    """max over `dims` (the last axes), 0 for an empty tensor."""
    if x.numel() == 0:
        return torch.zeros(x.shape[:x.dim() - dims], dtype=x.dtype,
                           device=x.device)
    return x.reshape(*x.shape[:x.dim() - dims], -1).amax(-1)


def rk4(f, x, u, p, dt, steps):
    h = dt / steps
    for _ in range(steps):
        k1 = f(x, u, p)
        k2 = f(x + 0.5 * h * k1, u, p)
        k3 = f(x + 0.5 * h * k2, u, p)
        k4 = f(x + h * k3, u, p)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


class OCP:
    """One benchmarked OCP (`vendor.usv_models.OCPS[name]`) on a
    device, in float64."""

    def __init__(self, name, device):
        d = OCPS[name]
        self.d = d
        self.device = torch.device(device)
        self.f, self.h = d["f"], d["h"]
        self.nx, self.nu, self.np, self.nh = d["nx"], d["nu"], d["np"], \
            d["nh"]
        self.N, self.Tf, self.steps = d["N"], d["Tf"], d["steps"]
        self.dt = self.Tf / self.N
        nx = self.nx

        def t(a):
            return torch.as_tensor(a, dtype=F64, device=self.device)

        W, We = (t(a) for a in d["cost"])
        s = self.dt                     # acados' cost scaling by dt
        self.W, self.We = s * W, We
        self.Qc, self.Sc, self.Rc = s * W[:nx, :nx], s * W[nx:, :nx], \
            s * W[nx:, nx:]
        self.QN = We
        self.idxbu = torch.as_tensor(d["idxbu"], dtype=torch.long,
                                     device=self.device)
        self.lbu, self.ubu = t(d["lbu"]), t(d["ubu"])
        self.idxbx = torch.as_tensor(d["idxbx"], dtype=torch.long,
                                     device=self.device)
        self.lbx, self.ubx = t(d["lbx"]), t(d["ubx"])
        self.uh = t(d["uh"])
        soft = d["soft"]
        sidx = soft["idx"] if soft else []
        self.soft = torch.as_tensor(sidx, dtype=torch.long,
                                    device=self.device)
        self.hard = torch.as_tensor(
            [i for i in range(self.nh) if i not in sidx], dtype=torch.long,
            device=self.device)
        if soft:
            self.zl, self.Zl, self.zu, self.Zu = (
                s * t(soft[k]) for k in ("zl", "Zl", "zu", "Zu"))
            self.lsh, self.ush = t(soft["lsh"]), t(soft["ush"])
        else:
            self.zl = self.Zl = self.zu = self.Zu = self.lsh = self.ush = \
                t([])

    # ------------------------------------------------------------------
    def linearize(self, xbar, ubar, p):
        """xbar (K, N+1, nx), ubar (K, N, nu), p (K, np) -> x_next, A, B
        (K, N, ...), hbar (K, N, nh), C (K, N, nh, nx) at stages 0..N-1."""
        K, N = xbar.shape[0], self.N
        xs = xbar[:, :-1].reshape(K * N, self.nx)
        us = ubar.reshape(K * N, self.nu)
        ps = p[:, None, :].expand(K, N, p.shape[-1]).reshape(K * N, -1)

        def step(x, u, pp):
            return rk4(self.f, x, u, pp, self.dt, self.steps)

        jac = torch.func.vmap(torch.func.jacfwd(step, argnums=(0, 1)))
        A, B = jac(xs, us, ps)
        x_next = torch.func.vmap(step)(xs, us, ps)
        hbar = self.h(xs, ps)
        C = torch.func.vmap(torch.func.jacfwd(self.h))(xs, ps)
        return (x_next.reshape(K, N, self.nx),
                A.reshape(K, N, self.nx, self.nx),
                B.reshape(K, N, self.nx, self.nu),
                hbar.reshape(K, N, self.nh),
                C.reshape(K, N, self.nh, self.nx))

    def qp(self, xbar, ubar, x0, p, lh, yref, yref_e, control=False):
        """The QP of one RTI tick for K problems (float64 inputs);
        `control`: its linearization rounded to TF32."""
        x_next, A, B, hbar, C = self.linearize(xbar, ubar, p)
        if control:
            x_next, A, B, hbar, C = (tf32(a) for a in (x_next, A, B, hbar,
                                                         C))
        nx = self.nx
        y = torch.cat([xbar[:, :-1], ubar], -1) - yref[:, None, :]
        g = y @ self.W.T                                  # (K, N, ny)
        qx = torch.cat([g[..., :nx],
                        ((xbar[:, -1] - yref_e) @ self.We.T)[:, None]], 1)
        return dict(A=A, B=B, c=x_next - xbar[:, 1:], dx0=x0 - xbar[:, 0],
                    hbar=hbar, C=C, qx=qx, qu=g[..., nx:], lh=lh,
                    xbar=xbar, ubar=ubar)

    # ------------------------------------------------------------------
    def cost(self, q, dx, du):
        """The QP objective of (dx (K, N+1, nx), du (K, N, nu)), each soft
        row with its best slacks."""
        N = self.N
        dxp = dx[:, :N]
        J = (0.5 * torch.einsum("kni,ij,knj->k", dxp, self.Qc, dxp)
             + torch.einsum("knu,ui,kni->k", du, self.Sc, dxp)
             + 0.5 * torch.einsum("knu,uv,knv->k", du, self.Rc, du)
             + (q["qx"][:, :N] * dxp).sum((1, 2)) + (q["qu"] * du).sum((1, 2))
             + 0.5 * torch.einsum("ki,ij,kj->k", dx[:, N], self.QN, dx[:, N])
             + (q["qx"][:, N] * dx[:, N]).sum(-1))
        if self.soft.numel():
            gv = (q["hbar"][..., self.soft]
                  + torch.einsum("knri,kni->knr", q["C"][:, :, self.soft],
                                 dxp))
            slh = q["lh"][:, None, self.soft]
            suh = self.uh[self.soft]
            sl = torch.maximum(self.lsh, slh - gv)
            su = torch.maximum(self.ush, gv - suh)
            J = J + (self.zl * sl + 0.5 * self.Zl * sl * sl + self.zu * su
                     + 0.5 * self.Zu * su * su).sum((1, 2))
        return J

    def feas(self, q, dx, du):
        """The largest violation of the QP's constraints by (dx, du)."""
        N = self.N
        dyn = (dx[:, 1:] - torch.einsum("knij,knj->kni", q["A"], dx[:, :N])
               - torch.einsum("knij,knj->kni", q["B"], du) - q["c"])
        worst = torch.maximum(_amax(dyn.abs(), 2),
                              _amax((dx[:, 0] - q["dx0"]).abs(), 1))
        u = (q["ubar"] + du)[..., self.idxbu]
        worst = torch.maximum(worst, _amax(torch.relu(self.lbu - u), 2))
        worst = torch.maximum(worst, _amax(torch.relu(u - self.ubu), 2))
        x = (q["xbar"] + dx)[:, 1:N][..., self.idxbx]
        worst = torch.maximum(worst, _amax(torch.relu(self.lbx - x), 2))
        worst = torch.maximum(worst, _amax(torch.relu(x - self.ubx), 2))
        if self.hard.numel():
            hv = (q["hbar"][:, 1:, self.hard]
                  + torch.einsum("knri,kni->knr",
                                 q["C"][:, 1:, self.hard], dx[:, 1:N]))
            worst = torch.maximum(worst, _amax(torch.relu(
                q["lh"][:, None, self.hard] - hv), 2))
            worst = torch.maximum(worst, _amax(torch.relu(
                hv - self.uh[self.hard]), 2))
        return worst

    # ------------------------------------------------------------------
    def solve(self, q, max_iter=80, tol=1e-12):
        """The QP's optimum: (dx, du, converged (K,) bool)."""
        K, N, nx, nu = q["A"].shape[0], self.N, self.nx, self.nu
        n = N * nu
        dev = self.device
        A, B = q["A"], q["B"]
        # ---- condensing: dx_k = E_k w + e_k, w = du flattened ----
        E = torch.zeros((K, N + 1, nx, n), dtype=F64, device=dev)
        e = torch.zeros((K, N + 1, nx), dtype=F64, device=dev)
        e[:, 0] = q["dx0"]
        for k in range(N):
            E[:, k + 1] = A[:, k] @ E[:, k]
            E[:, k + 1, :, k * nu:(k + 1) * nu] += B[:, k]
            e[:, k + 1] = (A[:, k] @ e[:, k, :, None])[..., 0] + q["c"][:, k]
        Ep, ep = E[:, :N], e[:, :N]
        QE = torch.einsum("ij,knjm->knim", self.Qc, Ep)
        H = torch.einsum("knim,knil->kml", Ep, QE)
        H = H + torch.einsum("kim,ij,kjl->kml", E[:, N], self.QN, E[:, N])
        SE = torch.einsum("ui,knim->knum", self.Sc, Ep).reshape(K, n, n)
        H = H + SE + SE.transpose(1, 2)
        H = H + torch.block_diag(*([self.Rc] * N))
        g = (torch.einsum("knim,kni->km", Ep,
                          ep @ self.Qc.T + q["qx"][:, :N])
             + torch.einsum("kim,ki->km", E[:, N],
                            e[:, N] @ self.QN.T + q["qx"][:, N])
             + (ep @ self.Sc.T + q["qu"]).reshape(K, n))
        # ---- hard rows G w <= h ----
        Gs, hs = [], []
        eye = torch.eye(n, dtype=F64, device=dev).reshape(N, nu, n)
        ub = q["ubar"][..., self.idxbu]                       # (K, N, nbu)
        Gu = eye[:, self.idxbu].reshape(-1, n).expand(K, -1, -1)
        Gs += [Gu, -Gu]
        hs += [(self.ubu - ub).reshape(K, -1), (ub - self.lbu).reshape(K, -1)]
        if self.idxbx.numel():
            Ex = E[:, 1:N][:, :, self.idxbx].reshape(K, -1, n)
            xe = (q["xbar"][:, 1:N] + e[:, 1:N])[..., self.idxbx]
            Gs += [Ex, -Ex]
            hs += [(self.ubx - xe).reshape(K, -1),
                   (xe - self.lbx).reshape(K, -1)]
        if self.hard.numel():
            Ch = q["C"][:, 1:, self.hard]
            CE = torch.einsum("knri,knim->knrm", Ch, E[:, 1:N]).reshape(
                K, -1, n)
            hv = q["hbar"][:, 1:, self.hard] + torch.einsum(
                "knri,kni->knr", Ch, e[:, 1:N])
            Gs += [-CE, CE]
            hs += [(hv - q["lh"][:, None, self.hard]).reshape(K, -1),
                   (self.uh[self.hard] - hv).reshape(K, -1)]
        G, h = torch.cat(Gs, 1), torch.cat(hs, 1)
        # ---- soft rows a = D w + d ----
        ns_row = self.soft.numel()
        if ns_row:
            Cs = q["C"][:, :, self.soft]
            D = torch.einsum("knri,knim->knrm", Cs, Ep).reshape(K, -1, n)
            d = (q["hbar"][..., self.soft]
                 + torch.einsum("knri,kni->knr", Cs, ep)).reshape(K, -1)
            rep = lambda v: v.repeat(N)                       # noqa: E731
            slh = q["lh"][:, self.soft].repeat(1, N)
            suh, lsh, ush = (rep(v) for v in (self.uh[self.soft], self.lsh,
                                                self.ush))
            zl, Zl, zu, Zu = (rep(v) for v in (self.zl, self.Zl, self.zu,
                                               self.Zu))
        else:
            D = torch.zeros((K, 0, n), dtype=F64, device=dev)
            d = slh = torch.zeros((K, 0), dtype=F64, device=dev)
            suh = lsh = ush = zl = Zl = zu = Zu = torch.zeros(
                0, dtype=F64, device=dev)
        w = torch.zeros((K, n), dtype=F64, device=dev)
        sl = torch.maximum(lsh, slh - d) + 1.0
        su = torch.maximum(ush + 0 * d, d - suh) + 1.0
        DT, GT = D.transpose(1, 2), G.transpose(1, 2)

        def primal(w, sl, su):
            a = (D @ w[..., None])[..., 0] + d
            return ((h - (G @ w[..., None])[..., 0]), a + sl - slh,
                    suh - a + su, sl - lsh, su - ush)

        s = [torch.clamp_min(r, 1.0) for r in primal(w, sl, su)]
        lam = [1.0 / si for si in s]
        m_tot = sum(si.shape[1] for si in s)
        done = torch.zeros(K, dtype=torch.bool, device=dev)
        for _ in range(max_iter):
            r = primal(w, sl, su)
            rp = [ri - si for ri, si in zip(r, s)]
            lh_, l1, l2, l3, l4 = lam
            rdw = ((H @ w[..., None])[..., 0] + g
                   + (GT @ lh_[..., None])[..., 0]
                   + (DT @ (l2 - l1)[..., None])[..., 0])
            rds = Zl * sl + zl - l1 - l3
            rdu = Zu * su + zu - l2 - l4
            mu = sum((si * li).sum(1) for si, li in zip(s, lam)) / m_tot
            res = torch.maximum(_amax(torch.cat(rp, 1).abs(), 1),
                                _amax(torch.cat([rdw, rds, rdu], 1).abs(),
                                      1))
            done = done | ((mu < tol) & (res < 1e-9))
            if bool(done.all()):
                break
            Sig = [li / si for li, si in zip(lam, s)]
            Ksl = Zl + Sig[1] + Sig[3]
            Ksu = Zu + Sig[2] + Sig[4]
            wD = Sig[1] + Sig[2] - Sig[1] ** 2 / Ksl - Sig[2] ** 2 / Ksu
            Kred = H + GT @ (Sig[0][..., None] * G) + DT @ (wD[..., None] * D)
            L, info = torch.linalg.cholesky_ex(Kred)
            if bool((info != 0).any()):
                jit = 1e-12 * Kred.diagonal(dim1=1, dim2=2).abs().amax(1)
                L, _ = torch.linalg.cholesky_ex(
                    Kred + jit[:, None, None] * torch.eye(
                        n, dtype=F64, device=dev))

            def newton(target):
                v = [(si * li - ti + li * rpi) / si
                     for si, li, ti, rpi in zip(s, lam, target, rp)]
                bw = (-rdw + (GT @ v[0][..., None])[..., 0]
                      + (DT @ (v[2] - v[1])[..., None])[..., 0])
                bs = -rds - v[1] - v[3]
                bu = -rdu - v[2] - v[4]
                rhs = (bw - (DT @ (Sig[1] * bs / Ksl)[..., None])[..., 0]
                       + (DT @ (Sig[2] * bu / Ksu)[..., None])[..., 0])
                dw = torch.cholesky_solve(rhs[..., None], L)[..., 0]
                Ddw = (D @ dw[..., None])[..., 0]
                dsl = (bs - Sig[1] * Ddw) / Ksl
                dsu = (bu + Sig[2] * Ddw) / Ksu
                ds = [-(G @ dw[..., None])[..., 0] + rp[0],
                      Ddw + dsl + rp[1], -Ddw + dsu + rp[2],
                      dsl + rp[3], dsu + rp[4]]
                dl = [-(si * li - ti + li * dsi) / si
                      for si, li, ti, dsi in zip(s, lam, target, ds)]
                return dw, dsl, dsu, ds, dl

            def max_step(ds, dl):
                a = torch.ones(K, dtype=F64, device=dev)
                for z, dz in zip(s + lam, ds + dl):
                    if z.shape[1] == 0:
                        continue
                    ratio = torch.where(dz < 0, -z / dz.clamp(max=-1e-300),
                                        torch.inf)
                    a = torch.minimum(a, ratio.amin(1))
                return a

            zero = [torch.zeros_like(si) for si in s]
            _, _, _, ds_a, dl_a = newton(zero)
            a_aff = max_step(ds_a, dl_a)
            mu_aff = sum(((si + a_aff[:, None] * dsi)
                          * (li + a_aff[:, None] * dli)).sum(1)
                         for si, li, dsi, dli in zip(s, lam, ds_a, dl_a)
                         ) / m_tot
            sigma = (mu_aff.clamp_min(0) / mu) ** 3
            target = [(sigma * mu)[:, None] - dsi * dli
                      for dsi, dli in zip(ds_a, dl_a)]
            dw, dsl, dsu, ds, dl = newton(target)
            alpha = torch.clamp(0.99 * max_step(ds, dl), max=1.0)
            alpha = torch.where(done, 0.0, alpha)[:, None]
            w = w + alpha * dw
            sl = sl + alpha * dsl
            su = su + alpha * dsu
            s = [si + alpha * dsi for si, dsi in zip(s, ds)]
            lam = [li + alpha * dli for li, dli in zip(lam, dl)]
        du = w.reshape(K, N, nu)
        dx = (E @ w[:, None, :, None])[..., 0] + e
        return dx, du, done

    # ------------------------------------------------------------------
    def judge(self, prior, answer, control=False):
        """Judge the program's ticks.  `prior`: dict of float64 tensors
        xbar (K, N+1, nx), ubar (K, N, nu), x0 (K, nx), p (K, np), lh (K,
        nh), yref (K, ny), yref_e (K, nx); `answer`: the program's new
        xbar, ubar.  Returns per-problem `feas`, `cost_gap` and the
        reference's convergence flag; with `control`, the same readings of
        the control's answer in the program's place."""
        q = self.qp(prior["xbar"], prior["ubar"], prior["x0"], prior["p"],
                    prior["lh"], prior["yref"], prior["yref_e"])
        dx_r, du_r, ok = self.solve(q)
        J_ref = self.cost(q, dx_r, du_r)
        if control:
            qc = self.qp(prior["xbar"], prior["ubar"], prior["x0"],
                         prior["p"], prior["lh"], prior["yref"],
                         prior["yref_e"], control=True)
            dx, du, ok_c = self.solve(qc)
            ok = ok & ok_c
        else:
            dx = answer["xbar"] - prior["xbar"]
            du = answer["ubar"] - prior["ubar"]
        return dict(feas=self.feas(q, dx, du),
                    cost_gap=(self.cost(q, dx, du) - J_ref).abs(),
                    ref_ok=ok)
