"""SQP-RTI orchestration of the per-instance engine (counterpart of
`mpc_collisionavoidance_tpu/solver/sqp_rti.py`).

Each call performs exactly ONE Gauss-Newton linearization at the
warm-started trajectory, one QP solve and one full-step primal update (the
reference's nlp_solver_type="SQP_RTI" + GAUSS_NEWTON + ERK).  The warm
start is an explicit `SolverState` threaded through the calls.
`solve_converged` is the multi-iteration SQP loop for oracle tests and the
converged-SQP goldens.

Layouts: the JAX package's per-instance shapes with optional leading batch
axes, xbar (..., N+1, nx), ubar (..., N, nu), x0 (..., nx), params
(..., np), lh (..., nh), yref (..., N, ny), yref_e (..., ny_e); an input
without the batch axes is shared by every instance.  One call is both
`step_fn` and `jax.vmap(step_fn)` of the JAX package.  This is the
reference engine that the lane engine is held against and the engine of
the goldens (`parity/goldens.py`) and of the server's "vmap" engine.

The solver is bound to one device and dtype.  On a CUDA device the
linearization runs K2 (`ops/linearize.py`) and each IPM iteration K1
(`ops/riccati.py`); on the CPU their plain versions.  On a CUDA device
`step_fn` (and `step`), `prepare_fn` and `feedback_fn` each replay one
captured CUDA graph (`solver/capture.py`, the counterpart of `jax.jit`
over them): captured at the first call per entry, batch shape and
argument shapes, one unconditional segment (a fixed number of IPM
iterations, no escalation, no host read).  What they return belongs to
the caller, as jit's fresh arrays do: the program's outputs are copied
out after the launch, and the caller's state is copied in before it, so
two states may take turns through one solver.  `capture=False` runs the
tick op by op on the card, for comparisons; on the CPU it always runs op
by op.
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.ops import linearize
from mpc_collisionavoidance_tpu_torch.ops.dense_qp import dense_qp_solve
from mpc_collisionavoidance_tpu_torch.ops.ipm import ipm_solve
from mpc_collisionavoidance_tpu_torch.solver.capture import TickGraphs, fresh


class SolverState(NamedTuple):
    """Warm-start state carried across control ticks."""

    xbar: torch.Tensor  # (..., N+1, nx)
    ubar: torch.Tensor  # (..., N, nu)


class SolverOutput(NamedTuple):
    u0: torch.Tensor       # (..., nu) stage-0 optimal input
    x1: torch.Tensor       # (..., nx) stage-1 predicted state
    xtraj: torch.Tensor    # (..., N+1, nx) full predicted trajectory
    utraj: torch.Tensor    # (..., N, nu)
    qp_gap: torch.Tensor   # (...) IPM complementarity at exit
    status: torch.Tensor   # (...) int32: 0 ok / 1 not converged / 2 NaN


class RTISolver:
    """RTI step functions specialized to one OCPSpec on one device.

    Typical use::

        solver = RTISolver(spec, device="cuda", dtype=torch.float32)
        state = solver.init_state(x0)                     # x0 (..., nx)
        state, out = solver.step(state, x0, params, lh)   # one tick
    """

    def __init__(self, spec: OCPSpec, ipm_iters: int = 18,
                 ipm_tol: float = 1e-7, qp_backend: str = "riccati",
                 centering: str = "fixed", mu0=1.0, *, device, dtype,
                 capture: bool = True):
        """`qp_backend`: "riccati" (the stage-wise IPM, one Riccati solve
        per iteration: the HPIPM role) or "dense" (full condensing and a
        dense IPM: the qpOASES role).  `centering`: "fixed" or "mehrotra"
        (predictor-corrector, two Riccati solves per iteration; riccati
        backend only).  `mu0`: initial barrier weight, a float or "auto"
        (gradient-scaled per instance).  `capture`: on a CUDA device, run
        each entry as a captured graph (the main path); False runs it op
        by op (ignored on the CPU, which has no graphs).  A CUDA `device`
        on a host without one raises ValueError."""
        if qp_backend not in ("riccati", "dense"):
            raise ValueError(f"unknown qp_backend {qp_backend!r}; "
                             "expected 'riccati' or 'dense'")
        if centering not in ("fixed", "mehrotra"):
            raise ValueError(f"unknown centering {centering!r}")
        if centering != "fixed" and qp_backend == "dense":
            raise ValueError("mehrotra centering is implemented on the "
                             "riccati backend only")
        self.spec = spec
        self.layout = linearize.make_row_layout(spec)
        self.ipm_iters = ipm_iters
        self.ipm_tol = ipm_tol
        self.qp_backend = qp_backend
        self.centering = centering
        self.mu0 = mu0
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError(f"device {str(device)!r}: no CUDA device on "
                             "this host (torch.cuda.is_available() is "
                             "False)")
        self.dtype = dtype
        self._build_qp = linearize.QPBuilder(spec, self.layout,
                                             device=self.device, dtype=dtype)
        self._graphs = (TickGraphs(self) if capture
                        and self.device.type == "cuda" else None)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ---- state management ----
    def init_state(self, x0) -> SolverState:
        """acados-style initialization: every stage state = x0 (..., nx),
        controls = 0."""
        x0 = self._tensor(x0)
        N = self.spec.N
        batch = x0.shape[:-1]
        return SolverState(
            xbar=x0.unsqueeze(-2).expand(batch + (N + 1, x0.shape[-1]))
            .contiguous(),
            ubar=torch.zeros(batch + (N, self.spec.model.nu),
                             dtype=self.dtype, device=self.device))

    def _qp_solve(self, qp):
        if self.qp_backend == "riccati":
            return ipm_solve(qp, iters=self.ipm_iters, tol=self.ipm_tol,
                             centering=self.centering, mu0=self.mu0)
        return dense_qp_solve(qp, iters=self.ipm_iters, tol=self.ipm_tol)

    def _qp(self, state, x0, params, lh, yref, yref_e):
        b = self._build_qp
        yref = b.yref if yref is None else self._tensor(yref)
        yref_e = b.yref_e if yref_e is None else self._tensor(yref_e)
        params = self._tensor(params)
        lh = None if lh is None else self._tensor(lh)
        return b(state.xbar, state.ubar, x0, yref, yref_e, params, lh)

    @staticmethod
    def _advance(state, sol):
        # full RTI primal step (acados SQP_RTI takes the unit step)
        xbar = state.xbar + sol.dx
        ubar = state.ubar + sol.du
        out = SolverOutput(u0=ubar[..., 0, :], x1=xbar[..., 1, :],
                           xtraj=xbar, utraj=ubar, qp_gap=sol.gap,
                           status=sol.status)
        return SolverState(xbar=xbar, ubar=ubar), out

    def _run(self, name, tick, state, args):
        """`tick(state, *args) -> (None, result)`: its captured program's
        replay with the result copied out on a CUDA device (unless
        `capture=False`), else the tick itself."""
        if self._graphs is None:
            return tick(state, *args)[1]
        result, _ = self._graphs.run(name, tick, state, args, donate=False)
        return fresh(result)

    # ---- single RTI step ----
    def step_fn(self, state: SolverState, x0, params, lh=None,
                yref=None, yref_e=None):
        """One RTI tick: linearize at the warm start, solve the QP pinned
        at x0, take the full step.  Returns (new state, SolverOutput)."""
        return self._run("step", self._step, state,
                         (x0, params, lh, yref, yref_e))

    def _step(self, state, x0, params, lh, yref, yref_e, escalation=None):
        qp = self._qp(state, self._tensor(x0), params, lh, yref, yref_e)
        return None, self._advance(state, self._qp_solve(qp))

    def step(self, state, x0, params, lh=None, yref=None, yref_e=None):
        """`step_fn` (the JAX package's jitted wrapper; `step_fn` is
        captured already)."""
        return self.step_fn(state, x0, params, lh, yref, yref_e)

    # ---- RTI preparation/feedback split ----
    # The measured state enters the QP only through the pinning residual
    # dx0 = x0 - xbar[0], so prepare_fn + feedback_fn compose to exactly
    # step_fn: linearization and assembly run before the measurement
    # arrives, the feedback phase pays only the QP solve.
    def prepare_fn(self, state: SolverState, params, lh=None,
                   yref=None, yref_e=None):
        """Preparation phase: Gauss-Newton linearization at the warm-start
        iterate, pinned at the predicted state (dx0 = 0)."""
        return self._run("prepare", self._prepare, state,
                         (params, lh, yref, yref_e))

    def _prepare(self, state, params, lh, yref, yref_e, escalation=None):
        return None, self._qp(state, state.xbar[..., 0, :], params, lh,
                              yref, yref_e)

    def feedback_fn(self, state: SolverState, qp, x0):
        """Feedback phase: re-pin the prepared QP at the fresh measurement
        and solve.  `qp` comes from `prepare_fn` on the same state."""
        return self._run("feedback", self._feedback, state, (qp, x0))

    def _feedback(self, state, qp, x0, escalation=None):
        qp = qp._replace(dx0=self._tensor(x0) - state.xbar[..., 0, :])
        return None, self._advance(state, self._qp_solve(qp))

    # ---- converged SQP (oracle / non-realtime mode) ----
    def solve_converged(self, state: SolverState, x0, params, lh=None,
                        yref=None, yref_e=None, sqp_iters: int = 30,
                        step_alpha: float = 1.0):
        """Run `sqp_iters` SQP iterations (re-linearizing each time; on a
        CUDA device each a replay of the captured `step_fn`); returns the
        last state and the last iteration's output.

        `step_alpha`: primal step damping.  Full-step SQP can enter a
        period-2 limit cycle on long-horizon nonconvex problems from a cold
        start; damping moves the iteration path, not the fixed point."""
        out = None
        for _ in range(sqp_iters):
            st2, out = self.step_fn(state, x0, params, lh, yref, yref_e)
            if step_alpha != 1.0:
                st2 = SolverState(
                    xbar=state.xbar + step_alpha * (st2.xbar - state.xbar),
                    ubar=state.ubar + step_alpha * (st2.ubar - state.ubar))
                # report the damped iterate actually carried
                out = out._replace(u0=st2.ubar[..., 0, :],
                                   x1=st2.xbar[..., 1, :],
                                   xtraj=st2.xbar, utraj=st2.ubar)
            state = st2
        return state, out
