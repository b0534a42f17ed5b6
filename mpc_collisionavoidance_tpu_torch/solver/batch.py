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
(`riccati="sweep"`, the default), the parallel-scan Riccati in plain
PyTorch once per iteration (`riccati="pscan"`) or the fused whole-IPM
kernel once (`riccati="fused"`); on CPU tensors it runs their plain
PyTorch versions.  With `condense=M` the QP is partially condensed into
N/M macro stages of M nu controls before the IPM
(`ops/condense_partial.py`), so the Riccati kernel runs at (nx, M nu).

On a CUDA device `step_fn`, `prepare_fn` and `feedback_fn` each run as one
captured CUDA graph (`solver/capture.py`, the counterpart of the JAX
package's jitted tick): captured at first use per batch width and
argument shapes, then launched once per call, with the stall escalation
decided on the device.  The state they return is the solver's own (the
new state is written into it, as a donated argument) and, like the
outputs, holds until the next tick.  `capture=False` runs them op by op
instead, for comparisons and profiling.

`LaneSolverAdapter` gives one vehicle the per-instance API on this
engine at lane width 1.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.ops.condense_partial import (
    condense_lane_qp, expand_solution)
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
    Escalation, LaneQP, check_group, check_schedule, ipm_solve_lanes)
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes)
from mpc_collisionavoidance_tpu_torch.solver.capture import TickGraphs


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
                 stall_tol: Optional[float] = None, condense: int = 1, *,
                 device, dtype, capture: bool = True, group=None):
        """`riccati`: "sweep" (eager IPM, one Riccati sweep per iteration —
        the production path), "pscan" (the same with the parallel-scan
        Riccati, O(log N) depth, `ops/riccati_pscan.py`) or "fused" (the
        whole fixed-sigma IPM in one kernel launch, K3; fixed centering,
        float mu0, no escalation).
        `centering`: "fixed" (sigma = 0.1), "adaptive" (per-lane sigma
        from the previous fraction-to-boundary step) or "mehrotra"
        (predictor-corrector, two Riccati sweeps per iteration; sweep
        backend only).  `mu0`: float or "auto" (per-lane gradient-scaled).
        `extra_iters` / `stall_tol`: stall escalation (ops/ipm_lanes.py).
        `condense`: partial-condensing group size M (HPIPM's knob, the
        reference's PARTIAL_CONDENSING_HPIPM): groups of M shooting
        intervals are condensed before the IPM, so the Riccati chain
        walks N/M stages (`ops/condense_partial.py`).  1 = no condensing.
        Must divide N; incompatible with riccati="fused".
        `device`, `dtype`: where and in what precision the solver runs; the
        static cost blocks are moved there once, here.  `capture`: on a
        CUDA device, run each tick as a captured graph (the main path);
        False runs it op by op (ignored on the CPU, which has no graphs).
        `group`: the process group of the ranks over which the lane axis
        is sharded (a mesh's, `parallel/`): each rank steps its own lanes
        and the stall escalation's predicate is all-reduced over the
        group, as in JAX's sharded tick.  A captured CUDA tick captures
        that all-reduce (NCCL); a gloo group on a CUDA device needs
        `capture=False` (`ops/ipm_lanes.py::check_group`).  None: one
        device.
        `last_esc_iters`: the escalation iterations of the last tick, a
        device int32."""
        check_schedule(riccati, centering, mu0, extra_iters)
        self.device = torch.device(device)
        check_group(group, self.device, capture)
        self.group = group
        if condense < 1 or spec.N % condense != 0:
            raise ValueError(
                f"condense group size {condense} must divide N={spec.N}")
        if condense > 1 and riccati == "fused":
            raise ValueError("partial condensing is incompatible with the "
                             "fused whole-IPM kernel (static-cost baking); "
                             "use riccati='sweep' or 'pscan'")
        self.condense = int(condense)
        self.spec = spec
        self.ipm_iters = int(ipm_iters)
        self.ipm_tol = ipm_tol
        self.riccati = riccati
        self.centering = centering
        self.mu0 = mu0
        self.extra_iters = int(extra_iters)
        self.stall_tol = stall_tol
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

        # soft-row static weights in the order [softened h rows | softened
        # state-box rows] (JAX `LaneRTISolver.__init__`); a softened
        # state-box row leaves the hard box family and becomes a soft row
        # with a constant selection Jacobian (acados idxsbx semantics,
        # reference scripts/race_cars/acados_settings_dev.py:81-85)
        parts = []
        if spec.soft is not None:
            sp = spec.soft
            parts.append((sp.zl, sp.Zl, sp.zu, sp.Zu, sp.lsh, sp.ush))
        if spec.soft_bx is not None:
            sb = spec.soft_bx
            parts.append((sb.zl, sb.Zl, sb.zu, sb.Zu, sb.lsbx, sb.usbx))
        if parts:
            zl, Zl, zu, Zu, lsh, ush = (
                np.concatenate([np.asarray(p[i], float) for p in parts])
                for i in range(6))
            self.zl, self.Zl = dev(scale * zl)[:, None], \
                dev(scale * Zl)[:, None]
            self.zu, self.Zu = dev(scale * zu)[:, None], \
                dev(scale * Zu)[:, None]
            self.lsh, self.ush = dev(lsh)[:, None], dev(ush)[:, None]
        else:
            self.zl = self.Zl = self.zu = self.Zu = self.lsh = self.ush = \
                torch.zeros((0, 1), dtype=dtype, device=self.device)
        idxbx_all = np.asarray(m.idxbx, dtype=np.int64).reshape(-1)
        lbx_all = np.asarray(m.lbx, float).reshape(-1)
        ubx_all = np.asarray(m.ubx, float).reshape(-1)
        sbx_rows = (np.asarray(spec.soft_bx.idxsbx, dtype=np.int64)
                    .reshape(-1) if spec.soft_bx is not None
                    else np.zeros((0,), dtype=np.int64))
        hard_bx = np.setdiff1d(np.arange(idxbx_all.size), sbx_rows)

        self.idxbu = tuple(int(i) for i in np.asarray(m.idxbu).reshape(-1))
        self.idxbx = tuple(int(i) for i in idxbx_all[hard_bx])
        self.lbu = dev(np.asarray(m.lbu).reshape(-1))
        self.ubu = dev(np.asarray(m.ubu).reshape(-1))
        self.lbx = dev(lbx_all[hard_bx])
        self.ubx = dev(ubx_all[hard_bx])
        self.xmask = (torch.arange(N, device=self.device) > 0).to(
            dtype)[:, None, None]                         # (N, 1, 1)
        # the soft state-box rows: states, bounds, selection rows
        self.sbx_state_idx = tuple(int(i) for i in idxbx_all[sbx_rows])
        self.lbx_s = dev(lbx_all[sbx_rows])
        self.ubx_s = dev(ubx_all[sbx_rows])
        E_sbx = np.zeros((len(sbx_rows), m.nx))
        E_sbx[np.arange(len(sbx_rows)), idxbx_all[sbx_rows]] = 1.0
        self.E_sbx = dev(E_sbx)                           # (n_sbx, nx)

        # h rows split into hard and soft (same ordering as the reference)
        self.soft_idx = (tuple(int(i) for i in spec.soft.idxsh)
                         if spec.soft is not None else ())
        self.hard_idx = tuple(int(i) for i in spec.hard_h_rows())
        if m.nh:
            self.lh = dev(m.lh)
            self.uh = dev(m.uh)
        self._hi = torch.as_tensor(self.hard_idx, dtype=torch.long,
                                   device=self.device)
        self._si = torch.as_tensor(self.soft_idx, dtype=torch.long,
                                   device=self.device)
        self._sbi = torch.as_tensor(self.sbx_state_idx, dtype=torch.long,
                                    device=self.device)
        self._iu = torch.as_tensor(self.idxbu, dtype=torch.long,
                                   device=self.device)
        self._ix = torch.as_tensor(self.idxbx, dtype=torch.long,
                                   device=self.device)
        self.last_esc_iters = torch.zeros((), dtype=torch.int32,
                                          device=self.device)
        self._graphs = (TickGraphs(self) if capture
                        and self.device.type == "cuda" else None)

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
            usel = ubar[self._iu].transpose(0, 1)          # (N, nbu, L)
            ub_lo = self.lbu[None, :, None] - usel
            ub_hi = usel - self.ubu[None, :, None]
        else:
            ub_lo = ub_hi = torch.zeros((N, 0, L), **opts)

        # ---- state box residuals (stage 0 masked) ----
        if self.idxbx:
            xsel = xs[self._ix].transpose(0, 1)            # (N, nbx, L)
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

        # ---- soft state-box rows appended to the soft family: constant
        # selection Jacobian, stage 0 masked with an O(1) inactive band
        # (JAX `_build_qp`, solver/batch.py:394-417) ----
        n_sbx = len(self.sbx_state_idx)
        if n_sbx:
            Cs_bx = (self.E_sbx[None, :, :, None].expand(N, n_sbx, nx, L)
                     * self.xmask[:, :, None, :])
            hofs_bx = xs[self._sbi].transpose(0, 1) * self.xmask
            inner = self.xmask > 0
            slh_bx = torch.where(inner, self.lbx_s[None, :, None], -1.0)
            suh_bx = torch.where(inner, self.ubx_s[None, :, None], 1.0)
            Cs = torch.cat([Cs, Cs_bx], dim=1)
            hofs = torch.cat([hofs, hofs_bx], dim=1)
            slh = torch.cat([slh, slh_bx.expand(N, n_sbx, L)], dim=1)
            suh = torch.cat([suh, suh_bx.expand(N, n_sbx, L)], dim=1)

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
    def _solve_qp(self, qp: LaneQP, escalation):
        escalation = escalation or Escalation(self.device, self.group)
        idxbu, idxbx = self.idxbu, self.idxbx
        if self.condense > 1:
            qp, idxbu, aux = condense_lane_qp(qp, self.condense, idxbu,
                                              idxbx)
            idxbx = ()
        sol = ipm_solve_lanes(qp, idxbu, idxbx,
                              iters=self.ipm_iters, tol=self.ipm_tol,
                              riccati=self.riccati,
                              centering=self.centering, mu0=self.mu0,
                              extra_iters=self.extra_iters,
                              stall_tol=self.stall_tol,
                              escalation=escalation)
        self.last_esc_iters = escalation.iters
        if self.condense > 1:
            dx, du = expand_solution(aux, sol.dx, sol.du)
            sol = sol._replace(dx=dx, du=du)
        return sol

    def _advance(self, state: LaneState, sol):
        xbar = state.xbar + sol.dx.transpose(0, 1)         # (nx, N+1, L)
        ubar = state.ubar + sol.du.transpose(0, 1)         # (nu, N, L)
        new_state = LaneState(xbar=xbar, ubar=ubar)
        out = LaneOutput(u0=ubar[:, 0, :], x1=xbar[:, 1, :],
                         gap=sol.gap, status=sol.status)
        return new_state, out

    def _captured(self, name, tick, state, args, donate=True):
        result, program = self._graphs.run(name, tick, state, args, donate)
        self.last_esc_iters = program.escalation.iters
        return result

    def step_fn(self, state: LaneState, x0, params,
                lh: Optional[torch.Tensor] = None,
                yref=None, yref_e=None):
        """One RTI tick for the whole lane batch.

        x0 (nx, L), params (np, L), lh (nh, L) or (nh,) or None;
        yref (ny,) or (ny, L), yref_e (nx,) or (nx, L) — None uses the
        builder's static references.
        """
        args = (x0, params, lh, yref, yref_e)
        if self._graphs is not None:
            return self._captured("step", self._step, state, args)
        return self._step(state, *args)

    def _step(self, state, x0, params, lh, yref, yref_e, escalation=None):
        x0 = self._tensor(x0)
        params = self._tensor(params).contiguous()
        qp = self._build_qp(state, x0, params, lh, yref=yref,
                            yref_e=yref_e)
        sol = self._solve_qp(qp, escalation)
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
        args = (params, lh, yref, yref_e)
        if self._graphs is not None:
            return self._captured("prepare", self._prepare, state, args,
                                  donate=False)
        return self._prepare(state, *args)[1]

    def _prepare(self, state, params, lh, yref, yref_e, escalation=None):
        params = self._tensor(params).contiguous()
        return None, self._build_qp(state, state.xbar[:, 0, :], params, lh,
                                    yref=yref, yref_e=yref_e)

    def feedback_fn(self, state: LaneState, qp: LaneQP, x0):
        """Feedback phase: re-pin the prepared QP at the fresh measurement
        x0 (nx, L) and solve.  `qp` comes from `prepare_fn` on the same
        state."""
        if self._graphs is not None:
            return self._captured("feedback", self._feedback, state,
                                  (qp, x0))
        return self._feedback(state, qp, x0)

    def _feedback(self, state, qp, x0, escalation=None):
        qp = qp._replace(dx0=self._tensor(x0) - state.xbar[:, 0, :])
        return self._advance(state, self._solve_qp(qp, escalation))


class LaneSolverAdapter:
    """Instance-shaped facade over a :class:`LaneRTISolver` at lane
    width 1.

    Single-vehicle surfaces (the guidance controller,
    `sim/closed_loop.py`) were written against the per-instance
    `RTISolver` API: unbatched x0 (nx,), outputs u0 (nu,) / x1 (nx,).
    This adapter lets them ride the production lane engine (the captured
    tick on the card) unchanged.  Per-stage (N, ny) yref is not supported
    (the lane engine broadcasts one reference across stages); pass the 1-D
    (ny,) form.  The outputs are copies, so that they outlive the
    captured tick's buffers (which hold only until the next tick); the
    state is the lane engine's own.
    """

    def __init__(self, lane_solver: LaneRTISolver):
        self.lane = lane_solver
        self.spec = lane_solver.spec
        self.device = lane_solver.device
        self.dtype = lane_solver.dtype

    def init_state(self, x0) -> LaneState:
        """x0 (nx,) -> the lane warm start at width 1."""
        return self.lane.init_state(self.lane._tensor(x0)[None, :])

    def step_fn(self, state: LaneState, x0, params, lh=None,
                yref=None, yref_e=None):
        """One tick: x0 (nx,), params (np,), lh (nh,) or None, yref (ny,),
        yref_e (nx,) or None.  Returns (state, LaneOutput) with u0 (nu,),
        x1 (nx,), gap and status 0-d."""
        if yref is not None and torch.as_tensor(yref).ndim != 1:
            raise ValueError("LaneSolverAdapter takes a (ny,) yref; a "
                             "per-stage (N, ny) yref needs RTISolver")
        t = self.lane._tensor
        x0 = t(x0)[:, None]
        params = t(params)[:, None]
        if lh is not None:
            lh = t(lh)[:, None]
        st, o = self.lane.step_fn(state, x0, params, lh,
                                  yref=yref, yref_e=yref_e)
        return st, LaneOutput(u0=o.u0[:, 0].clone(), x1=o.x1[:, 0].clone(),
                              gap=o.gap[0].clone(),
                              status=o.status[0].clone())
