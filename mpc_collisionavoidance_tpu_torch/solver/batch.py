"""Lane-batched SQP-RTI solver — the production tick (counterpart of
`mpc_collisionavoidance_tpu/solver/batch.py`).

One Gauss-Newton linearization + one interior-point QP + a full primal
step per call, warm start carried across calls.  The scenario batch lives
on the minor-most lane axis of every tensor.

Layouts:
    trajectories  xbar (nx, N+1, L), ubar (nu, N, L)
    measurements  x0 (nx, L), params (np, L), lh (nh, L)

The solver is bound to one device and dtype.  The device picks the
kernels: on CUDA tensors the tick runs the fused linearization kernel
once, then either the Riccati kernel once per IPM iteration
(`riccati="sweep"`, the default) or the fused whole-IPM kernel once
(`riccati="fused"`); on CPU tensors it runs their plain PyTorch versions.

Not ported yet: partial condensing (`condense`), the pscan backend and
`LaneSolverAdapter`.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
    LaneQP, check_schedule, ipm_solve_lanes)
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes)


class LaneState(NamedTuple):
    xbar: torch.Tensor  # (nx, N+1, L)
    ubar: torch.Tensor  # (nu, N, L)


class LaneOutput(NamedTuple):
    u0: torch.Tensor      # (nu, L)
    x1: torch.Tensor      # (nx, L)
    gap: torch.Tensor     # (L,)
    status: torch.Tensor  # (L,) int32


def to_lanes(batch_first):
    """(B, d1, d2, ...) -> (d1, d2, ..., B), contiguous."""
    return torch.movedim(torch.as_tensor(batch_first), 0, -1).contiguous()


def from_lanes(lane):
    """(d1, ..., B) -> (B, d1, ...)."""
    return torch.movedim(lane, -1, 0)


class LaneRTISolver:
    def __init__(self, spec: OCPSpec, ipm_iters: int = 12,
                 ipm_tol: float = 1e-7, riccati: str = "sweep",
                 centering: str = "fixed", mu0=1.0, extra_iters: int = 0,
                 stall_tol: Optional[float] = None, *,
                 device, dtype):
        """`riccati`: "sweep" (eager IPM, one Riccati sweep per iteration —
        the production path) or "fused" (the whole fixed-sigma IPM in one
        kernel launch, K3; fixed centering, float mu0, no escalation).
        `centering`: "fixed" (sigma = 0.1), "adaptive" (per-lane sigma
        from the previous fraction-to-boundary step) or "mehrotra"
        (predictor-corrector, two Riccati sweeps per iteration; sweep
        backend only).  `mu0`: float or "auto" (per-lane gradient-scaled).
        `extra_iters` / `stall_tol`: stall escalation (ops/ipm_lanes.py).
        `device`, `dtype`: where and in what precision the solver runs; the
        static cost blocks are moved there once, here."""
        check_schedule(riccati, centering, mu0, extra_iters)
        if spec.soft_bx is not None:
            raise NotImplementedError("soft state-box rows are not ported "
                                      "yet")
        self.spec = spec
        self.ipm_iters = int(ipm_iters)
        self.ipm_tol = ipm_tol
        self.riccati = riccati
        self.centering = centering
        self.mu0 = mu0
        self.extra_iters = int(extra_iters)
        self.stall_tol = stall_tol
        self.device = torch.device(device)
        self.dtype = dtype
        m = spec.model
        N = spec.N
        scale = spec.stage_scale
        cost = spec.cost
        Vx, Vu, W = (np.asarray(cost.Vx), np.asarray(cost.Vu),
                     np.asarray(cost.W))
        Vx_e, W_e = np.asarray(cost.Vx_e), np.asarray(cost.W_e)

        def dev(a):
            return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                                   device=self.device)

        # static cost blocks (dt-scaled path stages, unscaled terminal)
        self.Qc = dev(scale * (Vx.T @ W @ Vx))
        self.Sc = dev(scale * (Vu.T @ W @ Vx))
        self.Rc = dev(scale * (Vu.T @ W @ Vu))
        self.QN = dev(Vx_e.T @ W_e @ Vx_e)
        self.Vx, self.Vu = dev(Vx), dev(Vu)
        self.M_x = dev(scale * (Vx.T @ W))                # (nx, ny)
        self.M_u = dev(scale * (Vu.T @ W))                # (nu, ny)
        self.Vx_e = dev(Vx_e)
        self.M_e = dev(Vx_e.T @ W_e)                      # (nx, ny_e)
        self.yref = dev(cost.yref)
        self.yref_e = dev(cost.yref_e)

        self.idxbu = tuple(int(i) for i in np.asarray(m.idxbu).reshape(-1))
        self.idxbx = tuple(int(i) for i in np.asarray(m.idxbx).reshape(-1))
        self.lbu = dev(np.asarray(m.lbu).reshape(-1))
        self.ubu = dev(np.asarray(m.ubu).reshape(-1))
        self.lbx = dev(np.asarray(m.lbx).reshape(-1))
        self.ubx = dev(np.asarray(m.ubx).reshape(-1))
        self.xmask = (torch.arange(N, device=self.device) > 0).to(
            dtype)[:, None, None]                         # (N, 1, 1)

        # h rows split into hard and soft (same ordering as the reference)
        self.soft_idx = (tuple(int(i) for i in spec.soft.idxsh)
                         if spec.soft is not None else ())
        self.hard_idx = tuple(int(i) for i in spec.hard_h_rows())
        if m.nh:
            self.lh = dev(m.lh)
            self.uh = dev(m.uh)
        if spec.soft is not None:
            sp = spec.soft
            self.zl, self.Zl = dev(scale * sp.zl)[:, None], \
                dev(scale * sp.Zl)[:, None]
            self.zu, self.Zu = dev(scale * sp.zu)[:, None], \
                dev(scale * sp.Zu)[:, None]
            self.lsh, self.ush = dev(sp.lsh)[:, None], dev(sp.ush)[:, None]
        else:
            self.zl = self.Zl = self.zu = self.Zu = self.lsh = self.ush = \
                torch.zeros((0, 1), dtype=dtype, device=self.device)
        self._hi = torch.as_tensor(self.hard_idx, dtype=torch.long,
                                   device=self.device)
        self._si = torch.as_tensor(self.soft_idx, dtype=torch.long,
                                   device=self.device)

    # ------------------------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def init_state(self, x0_batch) -> LaneState:
        """x0_batch: (B, nx) batch-first; returns the lane-layout warm start
        (acados-style: all stages at x0, zero controls)."""
        x0 = to_lanes(self._tensor(x0_batch))            # (nx, L)
        N = self.spec.N
        xbar = x0[:, None, :].expand(x0.shape[0], N + 1,
                                     x0.shape[1]).contiguous()
        ubar = torch.zeros((self.spec.model.nu, N, x0.shape[1]),
                           dtype=self.dtype, device=self.device)
        return LaneState(xbar=xbar, ubar=ubar)

    # ------------------------------------------------------------------
    def _build_qp(self, state: LaneState, x0, params, lh,
                  yref=None, yref_e=None) -> LaneQP:
        spec = self.spec
        m = spec.model
        nx, N = m.nx, spec.N
        xbar, ubar = state.xbar, state.ubar
        L = xbar.shape[-1]
        opts = dict(dtype=self.dtype, device=self.device)
        xs = xbar[:, :-1, :].contiguous()                  # (nx, N, L)

        # ---- dynamics + constraint linearization (one fused call) ----
        x_next, J, hbar_l, C = linearize_lanes(
            xs, ubar.contiguous(), params, model=m, dt=spec.dt,
            integrator_steps=spec.integrator_steps)
        A = J[:, :, :nx, :].contiguous()                   # (N, nx, nx, L)
        Bm = J[:, :, nx:, :].contiguous()                  # (N, nx, nu, L)
        c = (x_next - xbar[:, 1:, :]).transpose(0, 1).contiguous()

        # ---- cost gradients ----
        # runtime stage reference: (ny,) shared or (ny, L) per lane
        if yref is None:
            yref = self.yref[:, None, None]
        else:
            yref = self._tensor(yref)
            yref = yref[:, None, None] if yref.ndim == 1 else yref[:, None, :]
        y = (torch.einsum("yi,inl->ynl", self.Vx, xs)
             + torch.einsum("yu,unl->ynl", self.Vu, ubar)
             - yref)                                       # (ny, N, L)
        qx_path = torch.einsum("iy,ynl->nil", self.M_x, y)  # (N, nx, L)
        qu = torch.einsum("uy,ynl->nul", self.M_u, y)      # (N, nu, L)
        if yref_e is None:
            yref_e = self.yref_e[:, None]
        else:
            yref_e = self._tensor(yref_e)
            if yref_e.ndim == 1:
                yref_e = yref_e[:, None]
        yN = torch.einsum("yi,il->yl", self.Vx_e, xbar[:, -1, :]) - yref_e
        qx_N = torch.einsum("iy,yl->il", self.M_e, yN)     # (nx, L)
        qx = torch.cat([qx_path, qx_N[None]], dim=0)

        # ---- control box residuals ----
        if self.idxbu:
            usel = ubar[list(self.idxbu)].transpose(0, 1)  # (N, nbu, L)
            ub_lo = self.lbu[None, :, None] - usel
            ub_hi = usel - self.ubu[None, :, None]
        else:
            ub_lo = ub_hi = torch.zeros((N, 0, L), **opts)

        # ---- state box residuals (stage 0 masked) ----
        if self.idxbx:
            xsel = xs[list(self.idxbx)].transpose(0, 1)    # (N, nbx, L)
            inner = self.xmask > 0
            xb_lo = torch.where(inner, self.lbx[None, :, None] - xsel, -1.0)
            xb_hi = torch.where(inner, xsel - self.ubx[None, :, None], -1.0)
        else:
            xb_lo = xb_hi = torch.zeros((N, 0, L), **opts)

        # ---- nonlinear constraint rows ----
        if m.nh:
            hbar = hbar_l.transpose(0, 1)                  # (N, nh, L)
            lh_full = (self.lh[:, None] if lh is None
                       else self._tensor(lh))
            if lh_full.ndim == 1:
                lh_full = lh_full[:, None]
            uh_full = self.uh[:, None]
        else:
            hbar = torch.zeros((N, 0, L), **opts)
            lh_full = uh_full = torch.zeros((0, 1), **opts)
        hi, si = self._hi, self._si
        Ch = C[:, hi]
        hh_lo = lh_full[hi][None] - hbar[:, hi]
        hh_hi = hbar[:, hi] - uh_full[hi][None]
        Cs = C[:, si]
        hofs = hbar[:, si]
        slh = lh_full[si][None].expand(N, len(si), L)
        suh = uh_full[si][None].expand(N, len(si), L)

        return LaneQP(
            A=A, B=Bm, c=c, dx0=x0 - xbar[:, 0, :],
            Qc=self.Qc, QN=self.QN, Sc=self.Sc, Rc=self.Rc, qx=qx, qu=qu,
            ub_lo=ub_lo, ub_hi=ub_hi,
            xb_lo=xb_lo, xb_hi=xb_hi, xmask=self.xmask,
            Ch=Ch, hh_lo=hh_lo, hh_hi=hh_hi,
            Cs=Cs, hofs=hofs, slh=slh, suh=suh,
            zl=self.zl, Zl=self.Zl, zu=self.zu, Zu=self.Zu,
            lsh=self.lsh, ush=self.ush,
        )

    # ------------------------------------------------------------------
    def _solve_qp(self, qp: LaneQP):
        return ipm_solve_lanes(qp, self.idxbu, self.idxbx,
                               iters=self.ipm_iters, tol=self.ipm_tol,
                               riccati=self.riccati,
                               centering=self.centering, mu0=self.mu0,
                               extra_iters=self.extra_iters,
                               stall_tol=self.stall_tol)

    def _advance(self, state: LaneState, sol):
        xbar = state.xbar + sol.dx.transpose(0, 1)         # (nx, N+1, L)
        ubar = state.ubar + sol.du.transpose(0, 1)         # (nu, N, L)
        new_state = LaneState(xbar=xbar, ubar=ubar)
        out = LaneOutput(u0=ubar[:, 0, :], x1=xbar[:, 1, :],
                         gap=sol.gap, status=sol.status)
        return new_state, out

    def step_fn(self, state: LaneState, x0, params,
                lh: Optional[torch.Tensor] = None,
                yref=None, yref_e=None):
        """One RTI tick for the whole lane batch.

        x0 (nx, L), params (np, L), lh (nh, L) or (nh,) or None;
        yref (ny,) or (ny, L), yref_e (nx,) or (nx, L) — None uses the
        builder's static references.
        """
        x0 = self._tensor(x0)
        params = self._tensor(params).contiguous()
        qp = self._build_qp(state, x0, params, lh, yref=yref,
                            yref_e=yref_e)
        sol = self._solve_qp(qp)
        return self._advance(state, sol)

    # ---- RTI preparation/feedback split ----
    # The measurement enters the lane QP only through dx0 = x0 - xbar[:, 0],
    # so linearization + assembly can run before the measurement arrives
    # and the feedback phase pays only the IPM: prepare_fn(state) +
    # feedback_fn(state, qp, x0) compose to exactly step_fn(state, x0).
    # The prepared QP holds no view of the state's tensors (the assembly
    # copies what it reads), but it belongs to that state: a caller that
    # changes the state (a new lane's warm start) prepares again.
    def prepare_fn(self, state: LaneState, params,
                   lh: Optional[torch.Tensor] = None,
                   yref=None, yref_e=None) -> LaneQP:
        """Preparation phase: Gauss-Newton linearization + QP assembly at
        the warm-start iterate (dx0 = 0)."""
        params = self._tensor(params).contiguous()
        return self._build_qp(state, state.xbar[:, 0, :], params, lh,
                              yref=yref, yref_e=yref_e)

    def feedback_fn(self, state: LaneState, qp: LaneQP, x0):
        """Feedback phase: re-pin the prepared QP at the fresh measurement
        x0 (nx, L) and solve.  `qp` comes from `prepare_fn` on the same
        state."""
        qp = qp._replace(dx0=self._tensor(x0) - state.xbar[:, 0, :])
        return self._advance(state, self._solve_qp(qp))
