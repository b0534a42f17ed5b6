"""Lane-batched primal-dual interior point (counterpart of
`mpc_collisionavoidance_tpu/ops/ipm_lanes.py`).

Path-following with slack/dual elimination, one Riccati sweep per
iteration (two under Mehrotra centering), per-lane fraction-to-boundary,
convergence freeze and status.
The instance batch rides the minor-most lane axis; step size, duality gap,
freeze mask and status are per-lane (L,) vectors.  All ten slack/dual
families are carried: control box (lo/hi), state box (lo/hi), hard h rows
(lo/hi), soft rows (sl/su) and the slack bounds (bsl/bsu).

Two backends, picked by `riccati`:
- "sweep" (default): the iterations run as tensor code here, with
  one Riccati sweep per iteration through `ops.riccati_lanes.
  lqr_solve_lanes` (the CUDA kernel K1 for CUDA tensors, the plain sweep
  for CPU tensors).  Fixed, adaptive and Mehrotra centering, `mu0="auto"`,
  stall escalation and the gap trace.
- "fused": the whole fixed-sigma solve in one launch of the CUDA kernel K3
  (`kernels/ipm.py`) for CUDA tensors; for CPU tensors its plain version
  `fused_ipm_lanes_plain`, which is this module's eager iteration at the
  fixed schedule with the plain sweep.  Fixed sigma, scalar mu0, no
  escalation, no control-coupled rows (as the JAX package's fused kernel).

Ported: the dtype-aware gap floor / status tolerance, the freeze rule and
the status rules.  Not ported yet (raises `NotImplementedError`):
control-coupled rows `Dh`/`Ds` from partial condensing.

Stall escalation (the reference's `lax.while_loop`) is `extra_iters`
guarded steps.  Each computes on the device the loop's predicate (some
lane's finite gap above `stall`) and runs the body only if it holds; once
it fails the carry no longer changes, so every later predicate fails too,
and the carry and the count equal the reference's.  An `Escalation` guards
the steps: its plain form tests the predicate on the host (one sync per
step); `solver.capture.SegmentedCapture` turns each step into a CUDA
conditional node of a captured tick, with no host read.  Every step writes
its new carry into the carry's tensors in place, in both forms.
"""

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from mpc_collisionavoidance_tpu_torch.kernels import ipm as ipm_kernel
from mpc_collisionavoidance_tpu_torch.ops import lanes as ln
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
    LaneLQR, lqr_solve_lanes, lqr_solve_lanes_plain)


class LaneQP(NamedTuple):
    # dynamics
    A: torch.Tensor       # (N, nx, nx, L)
    B: torch.Tensor       # (N, nx, nu, L)
    c: torch.Tensor       # (N, nx, L)
    dx0: torch.Tensor     # (nx, L)
    # static cost blocks, already dt-scaled
    Qc: torch.Tensor      # (nx, nx)
    QN: torch.Tensor      # (nx, nx)
    Sc: torch.Tensor      # (nu, nx)
    Rc: torch.Tensor      # (nu, nu)
    qx: torch.Tensor      # (N+1, nx, L)
    qu: torch.Tensor      # (N, nu, L)
    # control box rows (gl form): du_sel - ub_lo >= 0 ; -du_sel - ub_hi >= 0
    ub_lo: torch.Tensor   # (N, nbu, L)
    ub_hi: torch.Tensor   # (N, nbu, L)
    # state box rows, stage 0 masked via xmask
    xb_lo: torch.Tensor   # (N, nbx, L)
    xb_hi: torch.Tensor   # (N, nbx, L)
    xmask: torch.Tensor   # (N, 1, 1) 0/1
    # hard h rows
    Ch: torch.Tensor      # (N, nHh, nx, L)
    hh_lo: torch.Tensor   # (N, nHh, L)   = lh_hard - hbar
    hh_hi: torch.Tensor   # (N, nHh, L)   = hbar - uh_hard
    # soft rows
    Cs: torch.Tensor      # (N, nS, nx, L)
    hofs: torch.Tensor    # (N, nS, L)
    slh: torch.Tensor     # (N, nS, L)
    suh: torch.Tensor     # (N, nS, L)
    zl: torch.Tensor      # (nS, 1)
    Zl: torch.Tensor      # (nS, 1)
    zu: torch.Tensor      # (nS, 1)
    Zu: torch.Tensor      # (nS, 1)
    lsh: torch.Tensor     # (nS, 1)
    ush: torch.Tensor     # (nS, 1)
    # control coupling of h/soft rows (partially condensed QPs) — not
    # ported; must be None
    Dh: Optional[torch.Tensor] = None
    Ds: Optional[torch.Tensor] = None


class LaneIPMSolution(NamedTuple):
    dx: torch.Tensor      # (N+1, nx, L)
    du: torch.Tensor      # (N, nu, L)
    gap: torch.Tensor     # (L,)
    eq_res: torch.Tensor  # (L,)
    status: torch.Tensor  # (L,) int32


def _lanes_sum(x):
    """Sum over every leading axis -> (L,)."""
    return x.reshape(-1, x.shape[-1]).sum(0)


def _min_ratio(z, Dz):
    """Per-lane fraction-to-boundary ratio over all leading axes."""
    neg = Dz < 0
    r = torch.where(neg, -z / torch.where(neg, Dz, -torch.ones_like(Dz)),
                    torch.full_like(z, float("inf")))
    return r.reshape(-1, r.shape[-1]).amin(0)


def _all_finite(x):
    """(N, n, L) -> (L,) bool: every entry of the lane finite."""
    return torch.isfinite(x).reshape(-1, x.shape[-1]).all(0)


def _gap(lam, t, n_total):
    return sum(_lanes_sum(li * ti) for li, ti in zip(lam, t)) / n_total


@functools.cache
def _index(idx: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """`idx` as a long tensor on `device`, copied there once: a captured
    tick may not copy from the host."""
    return torch.as_tensor(idx, dtype=torch.long, device=device)


class Escalation:
    """The guard of the stall-escalation steps, and their count.

    `loop(n, stalled, step)` runs up to `n` steps: before each, the device
    bool `stalled()` decides whether `step()` runs.  This plain form reads
    the predicate on the host and stops at the first False (the carry then
    no longer changes, so no later step would run).  `iters` is a device
    int32 that every step that runs adds one to."""

    def __init__(self, device):
        self.iters = torch.zeros((), dtype=torch.int32, device=device)

    def loop(self, n, stalled, step):
        for _ in range(n):
            if not bool(stalled()):
                break
            step()
            self.iters += 1


def check_schedule(riccati: str, centering: str, mu0, extra_iters: int):
    """Raise on an IPM schedule the lane engine cannot run.  The fused
    whole-IPM kernel bakes fixed sigma, a scalar mu0 and a fixed iteration
    count (as the JAX package's).  Shared by `ipm_solve_lanes`,
    `LaneRTISolver` and `SolverConfig`."""
    if riccati not in ("sweep", "fused"):
        raise ValueError(f"unknown riccati backend '{riccati}'")
    if riccati == "fused":
        if centering != "fixed":
            raise ValueError(f"{centering} centering is not available in "
                             "the fused whole-IPM kernel (fixed sigma); use "
                             "riccati='sweep'")
        if isinstance(mu0, str):
            raise ValueError("mu0='auto' is not available in the fused "
                             "whole-IPM kernel (scalar mu0); use "
                             "riccati='sweep'")
        if extra_iters:
            raise ValueError("stall escalation (extra_iters > 0) is not "
                             "available in the fused whole-IPM kernel; use "
                             "riccati='sweep'")
    if centering not in ("fixed", "adaptive", "mehrotra"):
        raise ValueError(f"unknown centering '{centering}'")
    if isinstance(mu0, str) and mu0 != "auto":
        raise ValueError(f"unknown mu0 '{mu0}' (float or 'auto')")
    if extra_iters < 0:
        raise ValueError("extra_iters must be >= 0")


def contiguous_qp(qp: LaneQP) -> LaneQP:
    """The same QP with every tensor contiguous, as the kernels take them
    (the QP assembly's einsums, transposes and expands may return other
    strides; a no-op for tensors that already are)."""
    return qp._replace(**{k: v.contiguous() for k, v in qp._asdict().items()
                          if v is not None})


def _eff_tol(tol, dtype):
    """The status-0 gate: `tol` in float64, at least 5e-7 (above the
    float32 gap floor) otherwise."""
    return tol if dtype == torch.float64 else max(tol, 5e-7)


def lane_status(dx, du, gap, eq_res, tol):
    """Per-lane status of a solution: 0 converged (gap and eq_res under
    the dtype-aware tolerance), 1 not converged, 2 non-finite.  eq_res
    participates: a NaN-poisoned lane can freeze at a finite iterate while
    its residual is NaN — that lane reports status 2."""
    eff_tol = _eff_tol(tol, gap.dtype)
    finite = (torch.isfinite(gap) & torch.isfinite(eq_res)
              & _all_finite(dx) & _all_finite(du))
    converged = (gap < eff_tol) & (eq_res < 1e3 * eff_tol)
    return torch.where(finite, torch.where(converged, 0, 1),
                       2).to(torch.int32)


def ipm_solve_lanes(qp: LaneQP,
                    idxbu: Tuple[int, ...],
                    idxbx: Tuple[int, ...],
                    iters: int = 12,
                    tau: float = 0.995,
                    sigma: float = 0.1,
                    tol: float = 1e-7,
                    mu0=1.0,
                    riccati: str = "sweep",
                    centering: str = "fixed",
                    extra_iters: int = 0,
                    stall_tol: Optional[float] = None,
                    return_gap_trace: bool = False,
                    escalation: Optional[Escalation] = None):
    """`riccati`: "sweep" (eager iterations, one Riccati sweep each) or
    "fused" (the whole fixed-sigma solve in one kernel launch; module
    docstring).  `centering="adaptive"` replaces the fixed sigma with the
    per-lane heuristic sigma_k = clip((1 - alpha_{k-1})^3, 1e-3, 0.5)
    driven by the previous fraction-to-boundary step;
    `centering="mehrotra"` is the predictor-corrector: an affine probe
    (a second Riccati sweep) sets sigma = clip((mu_aff/mu)^3, 1e-4, 0.99)
    and the corrector adds the second-order term (a lane whose probe is
    not finite falls back to sigma = 0.5).  `extra_iters` > 0
    enables stall escalation: after the `iters` fixed iterations, up to
    `extra_iters` more run while any lane's duality gap is above
    `stall_tol` (default: the dtype-aware status tolerance), guarded by
    `escalation` (a plain `Escalation` if None), whose `iters` counts them.

    Returns a `LaneIPMSolution`; on the sweep backend with
    `return_gap_trace`, `(solution, gaps)` with `gaps` (iters, L) the duality
    gap at the start of each fixed iteration (escalation iterations are not
    recorded).  The fused backend ignores `return_gap_trace`, as the
    reference's does."""
    check_schedule(riccati, centering, mu0, extra_iters)
    if riccati == "fused":
        if qp.Dh is not None or qp.Ds is not None:
            raise ValueError("the fused whole-IPM kernel does not support "
                             "control-coupled rows (Dh/Ds)")
        if qp.A.device.type == "cpu":
            fused = fused_ipm_lanes_plain
        else:
            fused, qp = ipm_kernel.fused_ipm_lanes_cuda, contiguous_qp(qp)
        dx, du, gap, eq_res = fused(qp, idxbu, idxbx, iters=iters, tau=tau,
                                    sigma=sigma, mu0=mu0)
        return LaneIPMSolution(dx=dx, du=du, gap=gap, eq_res=eq_res,
                               status=lane_status(dx, du, gap, eq_res, tol))

    if qp.Dh is not None or qp.Ds is not None:
        raise NotImplementedError("control-coupled rows (Dh/Ds, partial "
                                  "condensing) are not ported yet")
    eff_tol = _eff_tol(tol, qp.A.dtype)
    dx, du, gap, eq_res, gaps = _ipm_iterate(
        qp, idxbu, idxbx, iters=iters, tau=tau, sigma=sigma, mu0=mu0,
        centering=centering, extra_iters=extra_iters,
        stall=eff_tol if stall_tol is None else stall_tol,
        sweep=lqr_solve_lanes, escalation=escalation)
    sol = LaneIPMSolution(dx=dx, du=du, gap=gap, eq_res=eq_res,
                          status=lane_status(dx, du, gap, eq_res, tol))
    return (sol, gaps) if return_gap_trace else sol


def fused_ipm_lanes_plain(qp: LaneQP, idxbu: Tuple[int, ...],
                          idxbx: Tuple[int, ...], iters: int = 12,
                          tau: float = 0.995, sigma: float = 0.1,
                          mu0: float = 1.0):
    """Plain PyTorch version of the fused whole-IPM kernel K3: the eager
    iterations at the fixed schedule (fixed sigma, scalar mu0, no
    escalation), always through the plain Riccati sweep, whatever the
    device.  Returns (dx (N+1, nx, L), du (N, nu, L), gap (L,),
    eq_res (L,))."""
    return _ipm_iterate(qp, idxbu, idxbx, iters=iters, tau=tau, sigma=sigma,
                        mu0=float(mu0), centering="fixed", extra_iters=0,
                        stall=None, sweep=lqr_solve_lanes_plain,
                        escalation=None)[:4]


def _ipm_iterate(qp: LaneQP, idxbu, idxbx, *, iters, tau, sigma, mu0,
                 centering, extra_iters, stall, sweep, escalation):
    """The iterations, with `sweep(LaneLQR) -> (dx, du)` as the Newton
    step's Riccati solve and `escalation` guarding the escalation steps.
    Returns (dx, du, gap, eq_res, gaps (iters, L))."""
    N, nx, nu, L = qp.B.shape[0], qp.A.shape[1], qp.B.shape[2], qp.B.shape[-1]
    nbu, nbx = len(idxbu), len(idxbx)
    nHh = qp.Ch.shape[1]
    nS = qp.Cs.shape[1]
    dtype, device = qp.A.dtype, qp.A.device
    opts = dict(dtype=dtype, device=device)
    f64 = dtype == torch.float64
    n_total = max(N * (2 * nbu + 2 * nbx + 2 * nHh + 4 * nS), 1)
    gap_floor = 1e-13 if f64 else 3e-7
    iu = _index(tuple(int(i) for i in idxbu), device)
    ix = _index(tuple(int(i) for i in idxbx), device)

    def du_sel(du):
        return du[:, iu, :]

    def dx_sel(dx_path):
        return dx_path[:, ix, :]

    def g_families(dx, du):
        dxp = dx[:-1]
        g_ulo = du_sel(du) - qp.ub_lo
        g_uhi = -du_sel(du) - qp.ub_hi
        g_xlo = qp.xmask * dx_sel(dxp) - qp.xb_lo
        g_xhi = -qp.xmask * dx_sel(dxp) - qp.xb_hi
        hv = ln.srows_mv(qp.Ch, dxp)
        g_hlo = hv - qp.hh_lo
        g_hhi = -hv - qp.hh_hi
        gv = qp.hofs + ln.srows_mv(qp.Cs, dxp)
        return g_ulo, g_uhi, g_xlo, g_xhi, g_hlo, g_hhi, gv

    # ---------------- initialization ----------------
    dx = torch.zeros((N + 1, nx, L), **opts)
    du = torch.zeros((N, nu, L), **opts)
    g0 = g_families(dx, du)
    gv0 = g0[6]
    s_margin = 0.1
    sl = torch.maximum(qp.slh - gv0, qp.lsh) + s_margin
    su = torch.maximum(gv0 - qp.suh, qp.ush) + s_margin
    all_t = tuple(torch.clamp_min(g, 0.1) for g in g0[:6]) + (
        torch.clamp_min(gv0 - qp.slh + sl, 0.1),
        torch.clamp_min(qp.suh - gv0 + su, 0.1),
        torch.clamp_min(sl - qp.lsh, 0.1),
        torch.clamp_min(su - qp.ush, 0.1))
    if isinstance(mu0, str):
        # "auto": per-lane gradient-proportional initial barrier weight,
        # clipped to [1e-3, 1e6]
        g_scale = torch.maximum(qp.qx.abs().reshape(-1, L).amax(0),
                                qp.qu.abs().reshape(-1, L).amax(0))
        mu0 = torch.clamp(0.01 * g_scale, 1e-3, 1e6)[None, None, :]
    all_l = tuple(mu0 / t for t in all_t)

    # static cost blocks broadcast over (stage, lane); Sc4 is materialized
    # once, since the Riccati sweep reads it unchanged every iteration
    Qc4 = qp.Qc[None, :, :, None].expand(N, nx, nx, L)
    QN4 = qp.QN[None, :, :, None].expand(1, nx, nx, L)
    Sc4 = qp.Sc[None, :, :, None].expand(N, nu, nx, L).contiguous()
    Rc4 = qp.Rc[None, :, :, None].expand(N, nu, nu, L)
    eye_x = torch.eye(nx, **opts)[None, :, :, None]
    eye_u = torch.eye(nu, **opts)[None, :, :, None]

    def body(carry):
        (dx, du, sl, su), t, lam, sigma_l = carry
        (t_ulo, t_uhi, t_xlo, t_xhi, t_hlo, t_hhi,
         t_sl, t_su, t_bsl, t_bsu) = t
        (l_ulo, l_uhi, l_xlo, l_xhi, l_hlo, l_hhi,
         l_sl, l_su, l_bsl, l_bsu) = lam

        g_ulo, g_uhi, g_xlo, g_xhi, g_hlo, g_hhi, gv = g_families(dx, du)
        r_ulo, r_uhi = g_ulo - t_ulo, g_uhi - t_uhi
        r_xlo, r_xhi = g_xlo - t_xlo, g_xhi - t_xhi
        r_hlo, r_hhi = g_hlo - t_hlo, g_hhi - t_hhi
        r_sl = (gv - qp.slh + sl) - t_sl
        r_su = (qp.suh - gv + su) - t_su
        r_bsl = (sl - qp.lsh) - t_bsl
        r_bsu = (su - qp.ush) - t_bsu

        gap = _gap(lam, t, n_total)
        muv = (sigma_l * gap)[None, None, :]

        a_ulo, a_uhi = l_ulo / t_ulo, l_uhi / t_uhi
        a_xlo, a_xhi = l_xlo / t_xlo, l_xhi / t_xhi
        a_hlo, a_hhi = l_hlo / t_hlo, l_hhi / t_hhi
        a_sl, a_su = l_sl / t_sl, l_su / t_su
        a_bsl, a_bsu = l_bsl / t_bsl, l_bsu / t_bsu

        # mu-independent soft elimination scalars
        beta_l = qp.Zl + a_sl + a_bsl
        beta_u = qp.Zu + a_su + a_bsu
        abar_l = a_sl * (qp.Zl + a_bsl) / beta_l
        abar_u = a_su * (qp.Zu + a_bsu) / beta_u

        # ---- modified Hessians ----
        Qbar = Qc4
        if nbx:
            diag = torch.zeros((N, nx, L), **opts)
            diag[:, ix, :] += qp.xmask * (a_xlo + a_xhi)
            Qbar = Qbar + diag[:, :, None, :] * eye_x
        if nHh:
            Qbar = Qbar + ln.sgram_rows(qp.Ch, a_hlo + a_hhi)
        if nS:
            Qbar = Qbar + ln.sgram_rows(qp.Cs, abar_l + abar_u)
        Q_all = torch.cat([Qbar, QN4], dim=0)
        Rbar = Rc4
        if nbu:
            diag_u = torch.zeros((N, nu, L), **opts)
            diag_u[:, iu, :] += a_ulo + a_uhi
            Rbar = Rbar + diag_u[:, :, None, :] * eye_u

        # ---- mu-independent gradient bases + dynamics residuals ----
        dxp, dxN = dx[:-1], dx[-1]
        qx_base = (qp.qx[:-1]
                   + torch.einsum("ij,kjl->kil", qp.Qc, dxp)
                   + torch.einsum("ui,kul->kil", qp.Sc, du))
        qx_N = qp.qx[-1] + torch.einsum("ij,jl->il", qp.QN, dxN)
        qu_base = (qp.qu
                   + torch.einsum("ui,kil->kul", qp.Sc, dxp)
                   + torch.einsum("uv,kvl->kul", qp.Rc, du))
        cbar = ln.smv(qp.A, dxp) + ln.smv(qp.B, du) + qp.c - dx[1:]
        ddx0 = qp.dx0 - dx[0]

        def newton(mvec):
            """One Newton direction for the per-family complementarity
            targets `mvec` (10-tuple, each broadcastable to its t family):
            T dlam + Lam dt = m - Lam T e.  m = sigma*mu*e is the plain
            centering step; m = 0 Mehrotra's affine probe; m = sigma*mu -
            Dt_aff*Dlam_aff the corrector.  One Riccati sweep."""
            (m_ulo, m_uhi, m_xlo, m_xhi, m_hlo, m_hhi,
             m_sl, m_su, m_bsl, m_bsu) = mvec
            k_l = m_sl / t_sl + m_bsl / t_bsl - qp.zl - qp.Zl * sl \
                - a_sl * r_sl - a_bsl * r_bsl
            k_u = m_su / t_su + m_bsu / t_bsu - qp.zu - qp.Zu * su \
                - a_su * r_su - a_bsu * r_bsu
            qtil_l = m_sl / t_sl - a_sl * r_sl - a_sl * k_l / beta_l
            qtil_u = m_su / t_su - a_su * r_su - a_su * k_u / beta_u

            qx_path = qx_base
            if nbx:
                vec = qp.xmask * ((m_xlo / t_xlo - a_xlo * r_xlo)
                                  - (m_xhi / t_xhi - a_xhi * r_xhi))
                qx_path = qx_path.clone()
                qx_path[:, ix, :] += -vec
            v_hlo = m_hlo / t_hlo - a_hlo * r_hlo
            v_hhi = m_hhi / t_hhi - a_hhi * r_hhi
            if nHh:
                qx_path = qx_path - ln.srows_tv(qp.Ch, v_hlo)
                qx_path = qx_path + ln.srows_tv(qp.Ch, v_hhi)
            if nS:
                qx_path = qx_path - ln.srows_tv(qp.Cs, qtil_l) \
                    + ln.srows_tv(qp.Cs, qtil_u)
            qx_all = torch.cat([qx_path, qx_N[None]], dim=0)

            qu_bar = qu_base
            if nbu:
                vec_u = (m_ulo / t_ulo - a_ulo * r_ulo) \
                    - (m_uhi / t_uhi - a_uhi * r_uhi)
                qu_bar = qu_bar.clone()
                qu_bar[:, iu, :] += -vec_u

            # ---- Newton step via the lane Riccati sweep (the kernel takes
            # contiguous tensors; einsum may return permuted strides) ----
            Ddx, Ddu = sweep(LaneLQR(*(
                t.contiguous() for t in (qp.A, qp.B, cbar, Q_all, Sc4, Rbar,
                                         qx_all, qu_bar, ddx0))))
            Ddxp = Ddx[:-1]

            # ---- recover slack/dual steps ----
            Dgv = ln.srows_mv(qp.Cs, Ddxp) if nS else gv
            Dsl = (k_l - a_sl * Dgv) / beta_l if nS else sl
            Dsu = (k_u + a_su * Dgv) / beta_u if nS else su
            Dhv = ln.srows_mv(qp.Ch, Ddxp) if nHh else r_hlo * 0
            Dt = (
                du_sel(Ddu) + r_ulo,
                -du_sel(Ddu) + r_uhi,
                qp.xmask * dx_sel(Ddxp) + r_xlo,
                -qp.xmask * dx_sel(Ddxp) + r_xhi,
                Dhv + r_hlo,
                -Dhv + r_hhi,
                Dgv + Dsl + r_sl,
                -Dgv + Dsu + r_su,
                Dsl + r_bsl,
                Dsu + r_bsu,
            )
            Dlam = tuple((mv - li * ti) / ti - (li / ti) * Dti
                         for mv, li, ti, Dti in zip(mvec, lam, t, Dt))
            return Ddx, Ddu, Dsl, Dsu, Dt, Dlam

        if centering == "mehrotra":
            # ---- affine probe (sigma = 0): a second Riccati sweep ----
            zerov = torch.zeros_like(muv)
            Ddx_a, Ddu_a, _, _, Dt_a, Dl_a = newton((zerov,) * 10)
            alpha_a = torch.ones((L,), **opts)
            for z, Dz in zip(t + lam, Dt_a + Dl_a):
                if z.numel() == 0:
                    continue
                alpha_a = torch.minimum(alpha_a, _min_ratio(z, Dz))
            av_a = alpha_a[None, None, :]
            mu_aff = sum(
                _lanes_sum((li + av_a * Dli) * (ti + av_a * Dti))
                for li, ti, Dli, Dti in zip(lam, t, Dl_a, Dt_a)) / n_total
            mu_aff = torch.maximum(mu_aff, torch.zeros_like(mu_aff))
            aff_ok = (torch.isfinite(mu_aff) & torch.isfinite(alpha_a)
                      & _all_finite(Ddx_a) & _all_finite(Ddu_a))
            ratio = mu_aff / torch.clamp_min(gap, gap_floor)
            sig = torch.clamp(ratio * ratio * ratio, 1e-4, 0.99)
            sig = torch.where(aff_ok, sig, 0.5)   # plain centering fallback
            tgt = (sig * gap)[None, None, :]
            okv = aff_ok[None, None, :]
            # corrector: sigma*mu*e minus the second-order term
            # Dt_aff*Dlam_aff; a lane whose probe failed takes 0.5*mu
            mvec = tuple(
                torch.where(okv, tgt - Dti * Dli, 0.5 * gap[None, None, :])
                for Dti, Dli in zip(Dt_a, Dl_a))
            Ddx, Ddu, Dsl, Dsu, Dt, Dlam = newton(mvec)
        else:
            Ddx, Ddu, Dsl, Dsu, Dt, Dlam = newton((muv,) * 10)

        # ---- per-lane fraction-to-boundary ----
        alpha = torch.ones((L,), **opts)
        for z, Dz in zip(t + lam, Dt + Dlam):
            if z.numel() == 0:
                continue
            alpha = torch.minimum(alpha, tau * _min_ratio(z, Dz))

        step_ok = (torch.isfinite(alpha) & _all_finite(Ddx)
                   & _all_finite(Ddu))
        keep = (gap <= gap_floor) | ~step_ok
        alpha = torch.where(keep, torch.zeros_like(alpha), alpha)
        av = alpha[None, None, :]

        new_primal = (dx + av * Ddx, du + av * Ddu,
                      (sl + av * Dsl) if nS else sl,
                      (su + av * Dsu) if nS else su)
        new_t = tuple(ti + av * Dti for ti, Dti in zip(t, Dt))
        new_l = tuple(li + av * Dli for li, Dli in zip(lam, Dlam))
        if centering == "adaptive":
            one_m = 1.0 - torch.where(keep, torch.ones_like(alpha), alpha)
            new_sigma = torch.clamp(one_m * one_m * one_m, 1e-3, 0.5)
        else:
            new_sigma = sigma_l
        return (new_primal, new_t, new_l, new_sigma), gap

    # fixed centering keeps the historical constant; adaptive starts
    # cautious (0.5) and lets the first step's alpha take over
    sigma0 = torch.full((L,), sigma if centering == "fixed" else 0.5, **opts)
    carry = ((dx, du, sl, su), all_t, all_l, sigma0)
    gaps = []
    for _ in range(iters):
        carry, g = body(carry)
        gaps.append(g)
    gaps = torch.stack(gaps) if gaps else torch.zeros((0, L), **opts)

    if extra_iters:
        # stall escalation: the same body, run only while some lane is
        # still above the gate (bounded by extra_iters); non-finite lanes
        # are dead (status 2) and never escalate
        leaves = _leaves(carry)

        def stalled():
            g = _gap(carry[2], carry[1], n_total)
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            return (g > stall).any()

        def step():
            for dst, src in zip(leaves, _leaves(body(carry)[0])):
                if src is not dst:
                    dst.copy_(src)

        (escalation or Escalation(device)).loop(extra_iters, stalled, step)

    (dx, du, sl, su), t, lam, _ = carry
    gap = _gap(lam, t, n_total)
    cbar = ln.smv(qp.A, dx[:-1]) + ln.smv(qp.B, du) + qp.c - dx[1:]
    eq_res = cbar.abs().reshape(-1, L).amax(0)
    eq_res = torch.maximum(eq_res, (qp.dx0 - dx[0]).abs().amax(0))

    return dx, du, gap, eq_res, gaps


def _leaves(carry):
    """The carry's tensors in a fixed order."""
    (dx, du, sl, su), t, lam, sigma = carry
    return (dx, du, sl, su, *t, *lam, sigma)
