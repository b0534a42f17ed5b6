"""Dense QP engine over a fully condensed problem — the qpOASES role
(counterpart of `mpc_collisionavoidance_tpu/ops/dense_qp.py`).

An independent second QP path over the condensed problem
(`ops/condense.py`): a primal-dual interior-point method whose Newton step
is ONE dense symmetric solve of size (N*nu, N*nu) per iteration (a
`torch.linalg` Cholesky, and two triangular solves on the card:
`cholesky_solve`), with the soft-constraint slacks eliminated with the
same zl/Zl/lsh/ush semantics as `ops/ipm.py`, so the two engines solve
the same KKT system and agree to solver tolerance.
O(N^3 nu^3) per iteration against the Riccati engine's O(N (nx+nu)^3): it
wins only for short horizons or as a cross-check.

Layouts: per-instance shapes with optional leading batch axes; the step
size, duality measure, freeze mask and status are per instance.
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.ops.condense import (DenseQP,
                                                           condense, expand)
from mpc_collisionavoidance_tpu_torch.ops.ipm import (IPMSolution, QPData,
                                                      effective_tol,
                                                      gap_floor, ratio)
from mpc_collisionavoidance_tpu_torch.ops.riccati import cholesky, mv


def cholesky_solve(B, Lf):
    """X with (Lf Lf') X = B, for each matrix of a batch.  On a CUDA
    tensor two triangular solves (cuBLAS), which a CUDA graph captures
    as kernels: torch's `cholesky_solve` takes MAGMA for a batch, which
    refuses the capture, and cuSOLVER's potrs for a single system, which
    allocates in the stream (nodes that a captured tick's child graph
    cannot hold)."""
    if B.device.type != "cuda":
        return torch.cholesky_solve(B, Lf)
    Y = torch.linalg.solve_triangular(Lf, B, upper=False)
    return torch.linalg.solve_triangular(Lf.mT, Y, upper=True)


class DenseIPMSolution(NamedTuple):
    w: torch.Tensor       # (..., nz) stacked controls
    sl: torch.Tensor      # (..., mS)
    su: torch.Tensor      # (..., mS)
    gap: torch.Tensor     # (...) final complementarity
    status: torch.Tensor  # (...) int32: 0 ok, 1 not converged, 2 NaN


def dense_ipm_solve(d: DenseQP, iters: int = 18, tau: float = 0.995,
                    sigma: float = 0.1, tol: float = 1e-7,
                    mu0: float = 1.0) -> DenseIPMSolution:
    """Path-following IPM on the condensed QP (fixed iteration count)."""
    nz, mI, mS = d.g.shape[-1], d.dg.shape[-1], d.dc.shape[-1]
    dtype, device = d.H.dtype, d.H.device
    batch = d.g.shape[:-1]
    n_total = max(mI + 4 * mS, 1)

    w = torch.zeros(batch + (nz,), dtype=dtype, device=device)
    gv0 = d.dc
    sl = torch.maximum(d.slh - gv0, d.lsh) + 0.1
    su = torch.maximum(gv0 - d.suh, d.ush) + 0.1
    tg = torch.clamp(d.dg, min=0.1)
    tl = torch.clamp(gv0 - d.slh + sl, min=0.1)
    tu = torch.clamp(d.suh - gv0 + su, min=0.1)
    tsl = torch.clamp(sl - d.lsh, min=0.1)
    tsu = torch.clamp(su - d.ush, min=0.1)
    lg, ll, lu, lsl, lsu = (mu0 / t for t in (tg, tl, tu, tsl, tsu))

    floor = gap_floor(dtype)
    # Cholesky regularization: the condensed Hessian accumulates roundoff
    # over N stages of propagation, so a tiny diagonal shift keeps the
    # factorization positive definite near convergence
    reg = 1e-12 if dtype == torch.float64 else 1e-6
    eye = torch.eye(nz, dtype=dtype, device=device)
    GhatT, ChatT = d.Ghat.mT, d.Chat.mT

    def measure(ls, ts):
        return sum(torch.sum(li * ti, dim=-1)
                   for li, ti in zip(ls, ts)) / n_total

    for _ in range(iters):
        gv = mv(d.Chat, w) + d.dc
        r_tg = (mv(d.Ghat, w) + d.dg) - tg
        r_tl = (gv - d.slh + sl) - tl
        r_tu = (d.suh - gv + su) - tu
        r_tsl = (sl - d.lsh) - tsl
        r_tsu = (su - d.ush) - tsu
        ts = (tg, tl, tu, tsl, tsu)
        ls = (lg, ll, lu, lsl, lsu)
        gap = measure(ls, ts)
        mu = (sigma * gap).unsqueeze(-1)

        ag = lg / tg
        al, au, asl, asu = ll / tl, lu / tu, lsl / tsl, lsu / tsu

        beta_l = d.Zl + al + asl
        beta_u = d.Zu + au + asu
        k_l = mu / tl + mu / tsl - d.zl - d.Zl * sl - al * r_tl - asl * r_tsl
        k_u = mu / tu + mu / tsu - d.zu - d.Zu * su - au * r_tu - asu * r_tsu
        abar_l = al * (d.Zl + asl) / beta_l
        abar_u = au * (d.Zu + asu) / beta_u
        qtil_l = mu / tl - al * r_tl - al * k_l / beta_l
        qtil_u = mu / tu - au * r_tu - au * k_u / beta_u

        # dense Newton system: (H + G'AgG + C'(Al+Au)C) Dw = -rhs.  Near
        # convergence the active-row weights ag blow up, so the raw system
        # is too ill-conditioned for a float32 Cholesky; Jacobi
        # equilibration plus one iterative-refinement step recovers the
        # digits
        Heff = ((GhatT * ag.unsqueeze(-2)) @ d.Ghat
                + (ChatT * (abar_l + abar_u).unsqueeze(-2)) @ d.Chat + d.H)
        hard_vec = mu / tg - ag * r_tg
        rhs = (d.g + mv(d.H, w) - mv(GhatT, hard_vec)
               - mv(ChatT, qtil_l) + mv(ChatT, qtil_u))
        dscale = torch.rsqrt(torch.clamp(torch.diagonal(Heff, dim1=-2,
                                                        dim2=-1), min=1e-30))
        Hs = Heff * dscale.unsqueeze(-1) * dscale.unsqueeze(-2) + reg * eye
        chol = cholesky(Hs)

        def nsolve(b):
            return dscale * cholesky_solve(
                (dscale * b).unsqueeze(-1), chol).squeeze(-1)

        Dw = nsolve(-rhs)
        Dw = Dw - nsolve(mv(Heff, Dw) + rhs)   # one refinement step

        Dgv = mv(d.Chat, Dw)
        Dsl = (k_l - al * Dgv) / beta_l
        Dsu = (k_u + au * Dgv) / beta_u
        Dtg = mv(d.Ghat, Dw) + r_tg
        Dtl = Dgv + Dsl + r_tl
        Dtu = -Dgv + Dsu + r_tu
        Dtsl = Dsl + r_tsl
        Dtsu = Dsu + r_tsu
        Dts = (Dtg, Dtl, Dtu, Dtsl, Dtsu)
        Dls = ((mu - lg * tg) / tg - ag * Dtg,
               (mu - ll * tl) / tl - al * Dtl,
               (mu - lu * tu) / tu - au * Dtu,
               (mu - lsl * tsl) / tsl - asl * Dtsl,
               (mu - lsu * tsu) / tsu - asu * Dtsu)

        alpha_max = torch.full(batch, torch.inf, dtype=dtype, device=device)
        for zv, Dz in zip(ts + ls, Dts + Dls):
            alpha_max = torch.minimum(alpha_max, ratio(zv, Dz, (-1,)))
        alpha = torch.clamp(tau * alpha_max, max=1.0)

        step_ok = torch.isfinite(alpha) & torch.isfinite(Dw).all(-1)
        keep = ((gap <= floor) | ~step_ok).unsqueeze(-1)
        a = alpha.unsqueeze(-1)

        def upd(old, delta):
            return torch.where(keep, old, old + a * delta)

        w, sl, su = upd(w, Dw), upd(sl, Dsl), upd(su, Dsu)
        tg, tl, tu, tsl, tsu = (upd(t, D) for t, D in zip(ts, Dts))
        lg, ll, lu, lsl, lsu = (upd(lv, D) for lv, D in zip(ls, Dls))

    gap = measure((lg, ll, lu, lsl, lsu), (tg, tl, tu, tsl, tsu))
    finite = torch.isfinite(gap) & torch.isfinite(w).all(-1)
    status = torch.where(finite, torch.where(
        gap < effective_tol(tol, dtype), 0, 1), 2).to(torch.int32)
    return DenseIPMSolution(w=w, sl=sl, su=su, gap=gap, status=status)


def dense_qp_solve(qp: QPData, iters: int = 18, tol: float = 1e-7
                   ) -> IPMSolution:
    """Drop-in alternative to `ops.ipm.ipm_solve` via full condensing:
    the same QPData in, the same IPMSolution out."""
    N, _, nu = qp.B.shape[-3:]
    nS = qp.hofs.shape[-1]
    batch = qp.B.shape[:-3]
    d = condense(qp)
    sol = dense_ipm_solve(d, iters=iters, tol=tol)
    dx, du = expand(d, sol.w, N, nu)
    # a NaN-poisoned problem (a NaN dx0) freezes w at a finite value but
    # expands to a non-finite dx: status 2, as in ops/ipm.py
    finite = (torch.isfinite(dx).all(-1).all(-1)
              & torch.isfinite(du).all(-1).all(-1))
    return IPMSolution(
        dx=dx, du=du, sl=sol.sl.reshape(batch + (N, nS)),
        su=sol.su.reshape(batch + (N, nS)), gap=sol.gap,
        # the dynamics hold exactly by construction after condensing
        eq_res=torch.zeros(batch, dtype=dx.dtype, device=dx.device),
        status=torch.where(finite, sol.status, 2).to(torch.int32))
