"""Full-model node controllers: the single-layer PF node and the
velocity/thrust node (counterpart of
`mpc_collisionavoidance_tpu/guidance/nodes.py`).

Completes the node layer (SURVEY.md N6/N8) alongside the flagship
(`guidance/controller.py`), the inner loop (`guidance/low_level.py`) and
the plain guidance variants (`guidance/variants.py`):

- `PFController` — the reference `nmpc_pf` node (reference
  catkin_ws/src/nmpc_ca/src/nmpc_pf.cpp): single-layer path-following NMPC
  over the FULL 14-state hydrodynamic model driving thrusters directly.
  Waypoint manager + crab-angle (sin chi, cos chi) packing + carried
  Tport/Tstbd command memory + stage-1 thrust extraction + Tx/Tz control
  input telemetry.
- `ThrustMPCController` — the reference `acados_mpc` node (reference
  src/acados_mpc.cpp): 5-state velocity/thrust NMPC that tracks
  u_des = 1.0 m/s and publishes thrusters from the stage-1 state with
  carried thrust memory.

The ROS pub/sub seams become function arguments and returned NamedTuples;
the nodes' mutable members (`past_Tport`, `past_Tstbd`, `k`, acados warm
start) become explicit state carries.  Both nodes push a per-stage
reference, so they run on the per-instance engine (`RTISolver`), whose
leading batch axes make a tick serve a batch of vehicles.
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.config import require_device
from mpc_collisionavoidance_tpu_torch.guidance.controller import stack_last
from mpc_collisionavoidance_tpu_torch.guidance.waypoints import (
    MissionState, mission_init, waypoint_manager)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import (RTISolver,
                                                             SolverState)

# usv_pf state indices (reference src/nmpc_pf.cpp:63-78)
(PPSI, PSIN, PCOS, PU, PV, PR, PYE, PX1, PY1, PAK, PNEDX, PNEDY,
 PTPORT, PTSTBD) = range(14)
# usv_acados state indices (reference src/acados_mpc.cpp:60-66)
AU, AV, AR, ATPORT, ATSTBD = range(5)

# Tx/Tz *telemetry* map of the pf node (reference src/nmpc_pf.cpp:372-373).
# Note the reference quirk reproduced here: the pf MODEL's thrust map uses
# c = 1.0 (scripts/usv_pf/usv_model.py:77) but the node's control-input
# telemetry uses the asymmetric c = 0.78.
THRUST_C = 0.78
BEAM = 0.41


def _node_solver(spec, solver, ipm_iters, device, dtype):
    return solver or RTISolver(spec, ipm_iters=ipm_iters,
                               device=require_device(device), dtype=dtype)


def stage_refs(yvec, N, nx):
    """One (..., ny) reference -> the per-stage (..., N, ny) yref and the
    terminal (..., nx) yref_e."""
    return (yvec[..., None, :].expand(yvec.shape[:-1] + (N, yvec.shape[-1])),
            yvec[..., :nx])


class PFMeasurements(NamedTuple):
    """INS feedback (reference nmpc_pf.cpp velocity/position callbacks
    :198-213)."""
    u: torch.Tensor
    v: torch.Tensor
    r: torch.Tensor
    nedx: torch.Tensor
    nedy: torch.Tensor
    psi: torch.Tensor


class PFCommands(NamedTuple):
    """The pf node's published outputs (reference :349-376)."""
    t_port: torch.Tensor      # left thruster  = x1[Tport] (stage-1 state)
    t_stbd: torch.Tensor      # right thruster = x1[Tstbd]
    u_d: torch.Tensor         # desired speed (0.7 cruising / 0.0 done, :241-266)
    e_u: torch.Tensor         # speed error telemetry (:362)
    e_ye: torch.Tensor        # cross-track error telemetry (:363)
    tx: torch.Tensor          # Tx = Tp + 0.78*Ts (:372)
    tz: torch.Tensor          # Tz = (Tp - 0.78*Ts)*B/2 (:373)
    target: torch.Tensor      # (..., 2) current target waypoint (:234-236)
    ye: torch.Tensor
    active: torch.Tensor
    solver_status: torch.Tensor


class PFState(NamedTuple):
    mission: MissionState
    solver: SolverState
    past_t_port: torch.Tensor   # command memory (reference :359-360)
    past_t_stbd: torch.Tensor


class PFController:
    """Single-layer path-following NMPC over the full hydrodynamic model
    (reference nmpc_pf.cpp; 14 states, N = 100, Tf = 1 s)."""

    def __init__(self, spec=None, solver: RTISolver = None,
                 ipm_iters: int = 10, *, device="cuda",
                 dtype=torch.float32, **build_kw):
        """`spec`: the usv_pf OCP (None: the builder's, with `build_kw`);
        `solver`: an `RTISolver` for it, or None to build one with
        `ipm_iters` on `device` in `dtype` (a CUDA device on a host without
        one raises ValueError)."""
        self.spec = spec or builders.build("usv_pf", **build_kw)
        if self.spec.model.name != "usv_pf":
            raise ValueError(f"PFController runs usv_pf, not "
                             f"{self.spec.model.name}")
        self.solver = _node_solver(self.spec, solver, ipm_iters, device,
                                   dtype)
        self.device, self.dtype = self.solver.device, self.solver.dtype

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def _pack_x0(meas: PFMeasurements, past_tp, past_ts, ye, x1, y1, ak):
        """Measurement -> OCP initial state (reference control() :273-291).

        The crab angle chi = psi + beta goes into the (sinpsi, cospsi)
        slots while the psi slot keeps the raw heading — that asymmetry is
        the reference's own packing (:273-283)."""
        u = torch.where(meas.u == 0.0, 0.001, meas.u)  # callback guard :201-203
        beta = torch.atan2(meas.v, u + 0.001)
        chi = meas.psi + beta
        return stack_last([
            meas.psi, torch.sin(chi), torch.cos(chi), u, meas.v, meas.r,
            ye, x1, y1, ak, meas.nedx, meas.nedy, past_tp, past_ts])

    def _yref(self, ak, u_d):
        """Per-tick references (reference :299-329): drive (sinpsi, cospsi)
        to the segment heading and u to the cruise speed; all else zero."""
        yvec = ak.new_zeros(ak.shape + (self.spec.cost.ny,))
        yvec[..., PSIN] = torch.sin(ak)
        yvec[..., PCOS] = torch.cos(ak)
        yvec[..., PU] = u_d
        return stage_refs(yvec, self.spec.N, self.spec.model.nx)

    # ------------------------------------------------------------------
    def init_state(self, meas: PFMeasurements, waypoints, n_wp) -> PFState:
        """The state takes the solver's dtype (the JAX method's `dtype`
        argument is dropped)."""
        meas = PFMeasurements(*(self._tensor(m) for m in meas))
        mission = mission_init(self._tensor(waypoints), n_wp, meas.psi)
        zero = torch.zeros_like(meas.psi)
        x0 = self._pack_x0(meas, zero, zero, zero, zero, zero, zero)
        return PFState(mission=mission,
                       solver=self.solver.init_state(x0),
                       past_t_port=zero, past_t_stbd=zero)

    # ------------------------------------------------------------------
    def tick(self, state: PFState, meas: PFMeasurements, waypoints, n_wp):
        """One control tick (reference main loop :391-407; the node runs at
        `loop_rate(N)` = 100 Hz — the accidental horizon/rate tie noted in
        SURVEY.md section 5)."""
        meas = PFMeasurements(*(self._tensor(m) for m in meas))
        mission, frame = waypoint_manager(
            state.mission, self._tensor(waypoints), n_wp, meas.nedx,
            meas.nedy)
        active = mission.active

        x0 = self._pack_x0(meas, state.past_t_port, state.past_t_stbd,
                           frame.ye, frame.x1, frame.y1, frame.ak)
        yref, yref_e = self._yref(frame.ak, frame.u_d)
        params = torch.zeros((self.spec.model.np_,), dtype=self.dtype,
                             device=self.device)
        solver_state, out = self.solver.step_fn(state.solver, x0, params,
                                                yref=yref, yref_e=yref_e)

        # thrust from the STAGE-1 state (inputs are thrust rates, :346-350)
        # with the hard zero override when u_des == 0 (:352-355)
        stop = frame.u_d == 0.0
        t_port = torch.where(stop, 0.0, out.x1[..., PTPORT])
        t_stbd = torch.where(stop, 0.0, out.x1[..., PTSTBD])
        # command memory <- raw stage-1 values, held while inactive (the
        # reference never calls control() once the mission ends, :259-267)
        past_tp = torch.where(active, out.x1[..., PTPORT], state.past_t_port)
        past_ts = torch.where(active, out.x1[..., PTSTBD], state.past_t_stbd)

        cmds = PFCommands(
            t_port=t_port, t_stbd=t_stbd, u_d=frame.u_d,
            e_u=frame.u_d - meas.u, e_ye=-frame.ye,
            tx=t_port + THRUST_C * t_stbd,
            tz=(t_port - THRUST_C * t_stbd) * BEAM / 2.0,
            target=frame.target, ye=frame.ye, active=active,
            solver_status=out.status)
        return PFState(mission=mission, solver=solver_state,
                       past_t_port=past_tp, past_t_stbd=past_ts), cmds


# ----------------------------------------------------------------------
class ThrustMeasurements(NamedTuple):
    """Local velocity feedback (reference acados_mpc.cpp :148-156)."""
    u: torch.Tensor
    v: torch.Tensor
    r: torch.Tensor


class ThrustMPCCommands(NamedTuple):
    t_port: torch.Tensor
    t_stbd: torch.Tensor
    solver_status: torch.Tensor


class ThrustMPCState(NamedTuple):
    solver: SolverState
    past_t_port: torch.Tensor   # carried thrust memory (reference :209-210)
    past_t_stbd: torch.Tensor


class ThrustMPCController:
    """Velocity/thrust NMPC (reference acados_mpc.cpp): tracks
    u_des = 1.0 m/s over the 5-state model at 20 Hz (:127, :221)."""

    U_DES = 1.0   # reference :127

    def __init__(self, spec=None, solver: RTISolver = None,
                 ipm_iters: int = 10, *, device="cuda",
                 dtype=torch.float32, **build_kw):
        """As `PFController`'s, for the usv_acados OCP."""
        self.spec = spec or builders.build("usv_acados", **build_kw)
        if self.spec.model.name != "usv_acados":
            raise ValueError(f"ThrustMPCController runs usv_acados, not "
                             f"{self.spec.model.name}")
        self.solver = _node_solver(self.spec, solver, ipm_iters, device,
                                   dtype)
        self.device, self.dtype = self.solver.device, self.solver.dtype

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    @staticmethod
    def _pack_x0(meas: ThrustMeasurements, past_tp, past_ts):
        """reference control() :161-165 with the u == 0 guard :150-153."""
        u = torch.where(meas.u == 0.0, 0.001, meas.u)
        return stack_last([u, meas.v, meas.r, past_tp, past_ts])

    def init_state(self, meas: ThrustMeasurements) -> ThrustMPCState:
        """The state takes the solver's dtype (the JAX method's `dtype`
        argument is dropped)."""
        meas = ThrustMeasurements(*(self._tensor(m) for m in meas))
        zero = torch.zeros_like(meas.u)
        x0 = self._pack_x0(meas, zero, zero)
        return ThrustMPCState(solver=self.solver.init_state(x0),
                              past_t_port=zero, past_t_stbd=zero)

    def tick(self, state: ThrustMPCState, meas: ThrustMeasurements,
             u_des: float = U_DES):
        """One 20 Hz tick: yref = (u_des, 0, ..., 0) on every stage
        (reference :171-189), thrust from the stage-1 state (:200-204),
        memory <- stage-1 (:209-210)."""
        meas = ThrustMeasurements(*(self._tensor(m) for m in meas))
        x0 = self._pack_x0(meas, state.past_t_port, state.past_t_stbd)
        u_des = self._tensor(u_des)
        yvec = u_des.new_zeros(u_des.shape + (self.spec.cost.ny,))
        yvec[..., AU] = u_des
        yref, yref_e = stage_refs(yvec, self.spec.N, self.spec.model.nx)
        params = torch.zeros((self.spec.model.np_,), dtype=self.dtype,
                             device=self.device)
        solver_state, out = self.solver.step_fn(
            state.solver, x0, params, yref=yref, yref_e=yref_e)

        cmds = ThrustMPCCommands(t_port=out.x1[..., ATPORT],
                                 t_stbd=out.x1[..., ATSTBD],
                                 solver_status=out.status)
        return ThrustMPCState(solver=solver_state,
                              past_t_port=out.x1[..., ATPORT],
                              past_t_stbd=out.x1[..., ATSTBD]), cmds
