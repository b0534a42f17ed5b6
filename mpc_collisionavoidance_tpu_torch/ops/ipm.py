"""Primal-dual interior-point method for stage-structured QPs with soft
constraints — the per-instance engine's QP solver (counterpart of
`mpc_collisionavoidance_tpu/ops/ipm.py`, the role of HPIPM).

QP form (per SQP iteration):

    min   sum_k 0.5 w_k'H_k w_k + g_k'w_k
          + sum_k [ zl'sl_k + 0.5 sl_k'Zl sl_k + zu'su_k + 0.5 su_k'Zu su_k ]
    s.t.  dx_{k+1} = A_k dx_k + B_k du_k + c_k,      dx_0 = dx0
          Gx_k dx_k + Gu_k du_k - gl_k >= 0                       (hard rows)
          hofs_k + Cx_k dx_k - slh_k + sl_k >= 0                  (soft lower)
          suh_k - hofs_k - Cx_k dx_k + su_k >= 0                  (soft upper)
          sl_k >= lsh,  su_k >= ush                              (slack bounds)

Infeasible-start path following with a fixed iteration count: the slacks
and duals of every inequality family are eliminated into a modified stage
Hessian and gradient, one Riccati solve (`ops/riccati.py`, K1 on the card)
per iteration — two under Mehrotra centering — and one fraction-to-boundary
step per instance.

Layouts: the JAX package's per-instance shapes with optional leading batch
axes (`QPData`); every field carries the same batch axes.  Per-instance
scalars (the step size, the duality measure, mu0="auto", the freeze mask,
status) have the batch shape; the reductions behind them run over every
other axis.
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.ops.riccati import (LQRData,
                                                          lqr_solve, mv)


class QPData(NamedTuple):
    """Stage-structured QP with hard rows and softened rows."""

    # dynamics
    A: torch.Tensor     # (..., N, nx, nx)
    B: torch.Tensor     # (..., N, nx, nu)
    c: torch.Tensor     # (..., N, nx)
    dx0: torch.Tensor   # (..., nx)
    # cost
    Q: torch.Tensor     # (..., N+1, nx, nx)
    S: torch.Tensor     # (..., N, nu, nx)
    R: torch.Tensor     # (..., N, nu, nu)
    qx: torch.Tensor    # (..., N+1, nx)
    qu: torch.Tensor    # (..., N, nu)
    # hard inequality rows: Gx dx + Gu du - gl >= 0
    Gx: torch.Tensor    # (..., N, nI, nx)
    Gu: torch.Tensor    # (..., N, nI, nu)
    gl: torch.Tensor    # (..., N, nI)
    # soft rows: value g = hofs + Cx dx, relaxed slh <= g <= suh
    Cx: torch.Tensor    # (..., N, nS, nx)
    hofs: torch.Tensor  # (..., N, nS)
    slh: torch.Tensor   # (..., N, nS)
    suh: torch.Tensor   # (..., N, nS)
    zl: torch.Tensor    # (..., nS) linear lower-slack cost (dt-scaled)
    Zl: torch.Tensor    # (..., nS)
    zu: torch.Tensor    # (..., nS)
    Zu: torch.Tensor    # (..., nS)
    lsh: torch.Tensor   # (..., nS) slack lower bounds
    ush: torch.Tensor   # (..., nS)


class IPMSolution(NamedTuple):
    dx: torch.Tensor       # (..., N+1, nx)
    du: torch.Tensor       # (..., N, nu)
    sl: torch.Tensor       # (..., N, nS) lower slacks
    su: torch.Tensor       # (..., N, nS)
    gap: torch.Tensor      # (...) final complementarity measure
    eq_res: torch.Tensor   # (...) final dynamics residual inf-norm
    status: torch.Tensor   # (...) int32: 0 ok, 1 not converged, 2 NaN


def gap_floor(dtype):
    """The duality measure at which the iterate freezes: pushing an IPM
    past ~sqrt(eps) of the dtype makes lambda/t ratios overflow for active
    rows and poisons the solution with NaNs."""
    return 1e-13 if dtype == torch.float64 else 3e-7


def effective_tol(tol, dtype):
    """The status-0 tolerance: in float32 the gap floors at ~3e-7, so a
    1e-7 request would label fully converged solves status 1."""
    return tol if dtype == torch.float64 else max(tol, 5e-7)


def ratio(z, Dz, dims):
    """Fraction-to-boundary: min over `dims` of -z/Dz where Dz < 0; +inf
    where no entry decreases, and for an empty family."""
    r = torch.where(Dz < 0, -z / torch.where(Dz < 0, Dz, -1.0), torch.inf)
    if r.numel() == 0:
        shape = [n for i, n in enumerate(r.shape)
                 if i - r.ndim not in dims]
        return torch.full(shape, torch.inf, dtype=z.dtype, device=z.device)
    return torch.amin(r, dim=dims)


def _bmtv(M, v):
    """(..., a, b) x (..., a) -> (..., b)  (transpose matvec)."""
    return mv(M.mT, v)


def _weighted_gram(M, w, Mb=None):
    """(..., r, a), (..., r) [, (..., r, b)] -> sum_i w_i M_i M_i'."""
    Mb = M if Mb is None else Mb
    return (M.mT * w.unsqueeze(-2)) @ Mb


def _fsum(t):
    """Per-instance sum of a (..., N, r) family."""
    return t.sum(dim=(-2, -1))


def _s(x):
    """A per-instance scalar (...) broadcast against (..., N, r)."""
    return x[..., None, None]


def ipm_solve(qp: QPData, iters: int = 18, tau: float = 0.995,
              sigma: float = 0.1, tol: float = 1e-7,
              mu0=1.0, centering: str = "fixed",
              stamp=None) -> IPMSolution:
    """Solve the QP with `iters` fixed path-following iterations.

    `centering="mehrotra"` runs the Mehrotra predictor-corrector: an
    affine probe (sigma = 0), sigma = (mu_aff / mu)^3 and the second-order
    correction — two Riccati solves per iteration.  `mu0="auto"` scales the
    initial barrier weight to the QP's gradient magnitude per instance,
    clipped to [1, 1e6].  `stamp(point, value)`: the tracer's device stamp
    of a captured tick (`solver/capture.py`), called before the first
    iteration ("ipm.start") and after the last ("ipm.end", value
    `iters`)."""
    if centering not in ("fixed", "mehrotra"):
        raise ValueError(f"unknown centering '{centering}'")
    N, nI = qp.gl.shape[-2:]
    nS = qp.hofs.shape[-1]
    dtype, device = qp.A.dtype, qp.A.device
    batch = qp.dx0.shape[:-1]
    if isinstance(mu0, str):
        if mu0 != "auto":
            raise ValueError(f"unknown mu0 '{mu0}'")
        g_scale = torch.maximum(qp.qx.abs().amax(dim=(-2, -1)),
                                qp.qu.abs().amax(dim=(-2, -1)))
        mu0 = _s(torch.clamp(0.01 * g_scale, 1.0, 1e6))
    n_total = max(N * (nI + 4 * nS), 1)
    floor = gap_floor(dtype)
    # the slack costs and bounds, broadcast against (..., N, nS)
    zl, Zl, zu, Zu, lsh, ush = (v.unsqueeze(-2) for v in (
        qp.zl, qp.Zl, qp.zu, qp.Zu, qp.lsh, qp.ush))
    Q_path, Q_N = qp.Q[..., :-1, :, :], qp.Q[..., -1, :, :]

    def g_hard(dx, du):
        return mv(qp.Gx, dx[..., :-1, :]) + mv(qp.Gu, du) - qp.gl

    def g_soft_val(dx):
        return qp.hofs + mv(qp.Cx, dx[..., :-1, :])

    # ----- initialization -----
    dx = torch.zeros(batch + (N + 1, qp.A.shape[-1]), dtype=dtype,
                     device=device)
    du = torch.zeros(batch + (N, qp.B.shape[-1]), dtype=dtype, device=device)
    gv0 = g_soft_val(dx)
    sl = torch.maximum(qp.slh - gv0, lsh) + 0.1
    su = torch.maximum(gv0 - qp.suh, ush) + 0.1
    tg = torch.clamp(g_hard(dx, du), min=0.1)
    tl = torch.clamp(gv0 - qp.slh + sl, min=0.1)
    tu = torch.clamp(qp.suh - gv0 + su, min=0.1)
    tsl = torch.clamp(sl - lsh, min=0.1)
    tsu = torch.clamp(su - ush, min=0.1)
    lg, ll, lu, lsl, lsu = (mu0 / t for t in (tg, tl, tu, tsl, tsu))

    def measure(ls, ts):
        return sum(_fsum(li * ti) for li, ti in zip(ls, ts)) / n_total

    fam = (-2, -1)
    if stamp:
        stamp("ipm.start")
    for _ in range(iters):
        gv = g_soft_val(dx)
        r_tg = g_hard(dx, du) - tg
        r_tl = (gv - qp.slh + sl) - tl
        r_tu = (qp.suh - gv + su) - tu
        r_tsl = (sl - lsh) - tsl
        r_tsu = (su - ush) - tsu
        ts = (tg, tl, tu, tsl, tsu)
        ls = (lg, ll, lu, lsl, lsu)
        gap = measure(ls, ts)

        ag = lg / tg
        al, au, asl, asu = ll / tl, lu / tu, lsl / tsl, lsu / tsu

        # mu-independent soft-row elimination scalars
        beta_l = Zl + al + asl
        beta_u = Zu + au + asu
        abar_l = al * (Zl + asl) / beta_l
        abar_u = au * (Zu + asu) / beta_u

        # modified stage Hessians (mu-independent)
        Qbar_path = (Q_path + _weighted_gram(qp.Gx, ag)
                     + _weighted_gram(qp.Cx, abar_l + abar_u))
        Qbar = torch.cat([Qbar_path, qp.Q[..., -1:, :, :]], dim=-3)
        Rbar = qp.R + _weighted_gram(qp.Gu, ag)
        Sbar = qp.S + _weighted_gram(qp.Gu, ag, qp.Gx)

        # mu-independent gradient bases + dynamics residuals
        dxp = dx[..., :-1, :]
        qx_base = qp.qx[..., :-1, :] + mv(Q_path, dxp) + _bmtv(qp.S, du)
        qx_N = qp.qx[..., -1, :] + mv(Q_N, dx[..., -1, :])
        qu_base = qp.qu + mv(qp.S, dxp) + mv(qp.R, du)
        cbar = mv(qp.A, dxp) + mv(qp.B, du) + qp.c - dx[..., 1:, :]
        ddx0 = qp.dx0 - dx[..., 0, :]

        def newton(m_tg, m_tl, m_tu, m_tsl, m_tsu):
            """Newton direction for per-family complementarity targets m:
            T dlam + Lam dt = m - Lam T e."""
            k_l = (m_tl / tl + m_tsl / tsl - zl - Zl * sl
                   - al * r_tl - asl * r_tsl)
            k_u = (m_tu / tu + m_tsu / tsu - zu - Zu * su
                   - au * r_tu - asu * r_tsu)
            qtil_l = m_tl / tl - al * r_tl - al * k_l / beta_l
            qtil_u = m_tu / tu - au * r_tu - au * k_u / beta_u

            hard_vec = m_tg / tg - ag * r_tg
            qx_path = (qx_base - _bmtv(qp.Gx, hard_vec)
                       - _bmtv(qp.Cx, qtil_l) + _bmtv(qp.Cx, qtil_u))
            qxbar = torch.cat([qx_path, qx_N.unsqueeze(-2)], dim=-2)
            qubar = qu_base - _bmtv(qp.Gu, hard_vec)

            Ddx, Ddu = lqr_solve(LQRData(qp.A, qp.B, cbar, Qbar, Sbar, Rbar,
                                         qxbar, qubar, ddx0))

            # recover slack and dual steps
            Dgv = mv(qp.Cx, Ddx[..., :-1, :])
            Dsl = (k_l - al * Dgv) / beta_l
            Dsu = (k_u + au * Dgv) / beta_u
            Dtg = mv(qp.Gx, Ddx[..., :-1, :]) + mv(qp.Gu, Ddu) + r_tg
            Dtl = Dgv + Dsl + r_tl
            Dtu = -Dgv + Dsu + r_tu
            Dtsl = Dsl + r_tsl
            Dtsu = Dsu + r_tsu
            Dlg = (m_tg - lg * tg) / tg - ag * Dtg
            Dll = (m_tl - ll * tl) / tl - al * Dtl
            Dlu = (m_tu - lu * tu) / tu - au * Dtu
            Dlsl = (m_tsl - lsl * tsl) / tsl - asl * Dtsl
            Dlsu = (m_tsu - lsu * tsu) / tsu - asu * Dtsu
            return (Ddx, Ddu, Dsl, Dsu, (Dtg, Dtl, Dtu, Dtsl, Dtsu),
                    (Dlg, Dll, Dlu, Dlsl, Dlsu))

        if centering == "mehrotra":
            # ---- affine probe (sigma = 0) ----
            Ddx_a, Ddu_a, _, _, Dts_a, Dls_a = newton(0.0, 0.0, 0.0, 0.0,
                                                      0.0)
            alpha_a = torch.ones(batch, dtype=dtype, device=device)
            for zv, Dz in zip(ts + ls, Dts_a + Dls_a):
                alpha_a = torch.minimum(alpha_a, ratio(zv, Dz, fam))
            a = _s(alpha_a)
            mu_aff = measure([li + a * Dli for li, Dli in zip(ls, Dls_a)],
                             [ti + a * Dti for ti, Dti in zip(ts, Dts_a)])
            mu_aff = torch.clamp(mu_aff, min=0.0)
            aff_ok = (torch.isfinite(mu_aff) & torch.isfinite(alpha_a)
                      & torch.isfinite(Ddx_a).all(-1).all(-1)
                      & torch.isfinite(Ddu_a).all(-1).all(-1))
            r3 = mu_aff / torch.clamp(gap, min=floor)
            sig = torch.clamp(r3 * r3 * r3, 1e-4, 0.99)
            sig = torch.where(aff_ok, sig, 0.5)    # plain centering fallback
            # corrector: sigma*mu minus the second-order term Dt_aff*Dl_aff
            ok = _s(aff_ok)
            ms = tuple(torch.where(ok, _s(sig * gap) - Dti * Dli,
                                   _s(0.5 * gap))
                       for Dti, Dli in zip(Dts_a, Dls_a))
            Ddx, Ddu, Dsl, Dsu, Dts, Dls = newton(*ms)
        else:
            mu = _s(sigma * gap)
            Ddx, Ddu, Dsl, Dsu, Dts, Dls = newton(mu, mu, mu, mu, mu)

        alpha_max = torch.full(batch, torch.inf, dtype=dtype, device=device)
        for zv, Dz in zip(ts + ls, Dts + Dls):
            alpha_max = torch.minimum(alpha_max, ratio(zv, Dz, fam))
        alpha = torch.clamp(tau * alpha_max, max=1.0)

        # freeze the iterate once converged (see gap_floor); a NaN-poisoned
        # step is also rejected so earlier progress survives
        step_ok = (torch.isfinite(alpha)
                   & torch.isfinite(Ddx).all(-1).all(-1)
                   & torch.isfinite(Ddu).all(-1).all(-1))
        keep = _s((gap <= floor) | ~step_ok)
        a = _s(alpha)

        def upd(old, delta):
            return torch.where(keep, old, old + a * delta)

        dx, du, sl, su = upd(dx, Ddx), upd(du, Ddu), upd(sl, Dsl), \
            upd(su, Dsu)
        tg, tl, tu, tsl, tsu = (upd(t, D) for t, D in zip(ts, Dts))
        lg, ll, lu, lsl, lsu = (upd(lv, D) for lv, D in zip(ls, Dls))
    if stamp:
        stamp("ipm.end", iters)

    gap = measure((lg, ll, lu, lsl, lsu), (tg, tl, tu, tsl, tsu))
    cbar = mv(qp.A, dx[..., :-1, :]) + mv(qp.B, du) + qp.c - dx[..., 1:, :]
    eq_res = torch.maximum(cbar.abs().amax(dim=(-2, -1)),
                           (qp.dx0 - dx[..., 0, :]).abs().amax(dim=-1))

    # eq_res participates: a NaN-poisoned problem (a NaN measurement in
    # dx0) freezes the iterate at a finite value but leaves a non-finite
    # residual, which must surface as status 2
    finite = (torch.isfinite(gap) & torch.isfinite(eq_res)
              & torch.isfinite(dx).all(-1).all(-1)
              & torch.isfinite(du).all(-1).all(-1))
    eff_tol = effective_tol(tol, dtype)
    converged = (gap < eff_tol) & (eq_res < 1e3 * eff_tol)
    status = torch.where(finite, torch.where(converged, 0, 1), 2).to(
        torch.int32)
    return IPMSolution(dx=dx, du=du, sl=sl, su=su, gap=gap, eq_res=eq_res,
                       status=status)
