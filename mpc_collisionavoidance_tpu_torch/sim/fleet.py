"""Fleet mission engine: batch-first guidance logic + the lane-batched
solver (counterpart of `mpc_collisionavoidance_tpu/sim/fleet.py`).

Per tick, for B vehicles at once:

- mission management, perception and plant stepping run batch-first, (B,)
  fields (they are elementwise in the vehicle axis; the same functions
  serve one vehicle);
- the RTI solve runs in the lane engine with the vehicle axis minor-most:
  on the card one captured graph per tick (`solver/capture.py`);
- the only glue is a pair of O(nx*B) transposes per tick.

With tracing on (`utils/profiling.py`) a tick is the span `fleet.tick`
around `fleet.waypoints`, `fleet.perceive`, `fleet.pack`, `fleet.solve`
(the lane engine's `step_fn`), `fleet.plant` (its RK4 integrator the
span `fleet.integrate`) and `fleet.log`.

The full flagship node behavior (waypoint manager, top-8 LiDAR intake,
command memory) runs per vehicle.  The captured tick's outputs are the
solver's own buffers and hold only until its next tick, so what the log
keeps of them is copied.
"""

from typing import NamedTuple, Optional

import torch

from mpc_collisionavoidance_tpu_torch.config import (SolverConfig,
                                                     require_device)
from mpc_collisionavoidance_tpu_torch.guidance import obstacles as obs
from mpc_collisionavoidance_tpu_torch.guidance.controller import (
    GuidanceController, Measurements)
from mpc_collisionavoidance_tpu_torch.guidance.waypoints import (
    MissionState, mission_init, waypoint_manager)
from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.ops import integrators
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneState,
                                                           from_lanes,
                                                           to_lanes)
from mpc_collisionavoidance_tpu_torch.utils.angles import wrap_once
from mpc_collisionavoidance_tpu_torch.utils.profiling import span

IPSIED = 4  # ca1 state index of psi_e_d


class FleetState(NamedTuple):
    mission_k: torch.Tensor       # (B,) int32
    past_psied: torch.Tensor      # (B,)
    active: torch.Tensor          # (B,) bool
    solver: LaneState             # lane layout
    meas: Measurements            # (B,) fields


class FleetLog(NamedTuple):
    pos: torch.Tensor        # (T, B, 2)
    ye: torch.Tensor         # (T, B)
    psi_d: torch.Tensor      # (T, B)
    active: torch.Tensor     # (T, B)
    collision: torch.Tensor  # (T, B)
    status: torch.Tensor     # (T, B) per-tick solver status (0 ok)
    final: FleetState


class FleetMissionEngine:
    """B vehicles, each with its own waypoints, and a shared obstacle field
    or one per vehicle."""

    def __init__(self, spec: OCPSpec, config: Optional[SolverConfig] = None,
                 *, device="cuda", dtype=torch.float32, capture: bool = True,
                 group=None, **solver_kw):
        """`config`: the lane engine's `SolverConfig` (e.g.
        `config.production_engine()`, or `SolverConfig(riccati="fused")`);
        None builds one from `solver_kw` (`SolverConfig`'s fields) with the
        JAX engine's default of 10 IPM iterations.  `device`, `dtype`: where
        and in what precision the fleet runs (a CUDA device on a host
        without one raises ValueError); `capture`, `group`: the lane
        engine's (with a mesh's group, each rank runs its own vehicles,
        the vehicle axis sharded over the mesh, `parallel/`)."""
        if spec.model.name != "usv_guidance_ca1":
            raise ValueError(f"FleetMissionEngine runs usv_guidance_ca1, "
                             f"not {spec.model.name}")
        if config is None:
            config = SolverConfig(**{"ipm_iters": 10, **solver_kw})
        elif solver_kw:
            raise ValueError("pass either a SolverConfig or its fields")
        if config.engine != "lane":
            raise ValueError("the fleet runs the lane engine")
        self.spec = spec
        self.device, self.dtype = require_device(device), dtype
        self.solver = config.build(spec, device=self.device, dtype=dtype,
                                   capture=capture, group=group)
        self._plant = integrators.make_discrete_dynamics(
            spec.model.f, spec.dt, num_steps=4)
        self._params0 = torch.zeros((spec.model.np_,), dtype=dtype,
                                    device=self.device)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, meas: Measurements, waypoints, n_wp) -> FleetState:
        """meas fields (B,); waypoints (B, MAX_WP, 2); n_wp (B,).  The
        state takes the solver's dtype (the JAX method's `dtype` argument
        is dropped)."""
        meas = Measurements(*(self._tensor(m) for m in meas))
        mission = mission_init(self._tensor(waypoints), n_wp, meas.psi)
        zero = torch.zeros_like(meas.psi)
        x0 = GuidanceController._pack_x0(meas, mission.past_psied, zero,
                                         zero)
        return FleetState(
            mission_k=mission.k, past_psied=mission.past_psied,
            active=mission.active,
            solver=self.solver.init_state(x0), meas=meas)

    # ------------------------------------------------------------------
    def tick(self, state: FleetState, waypoints, n_wp,
             obstacle_field, field_valid):
        """One 20 Hz tick for the whole fleet.  The inputs are tensors on
        the engine's device: waypoints (B, MAX_WP, 2), n_wp (B,) int32, the
        field (M, 3) shared or (B, M, 3) per vehicle and its mask.
        Returns (new state, (pos, ye, psi_d, active, collision, status)),
        each of the log's tensors the tick's own."""
        with span("fleet.tick"):
            return self._tick(state, waypoints, n_wp, obstacle_field,
                              field_valid)

    def _tick(self, state, waypoints, n_wp, obstacle_field, field_valid):
        meas = state.meas
        with span("fleet.waypoints"):
            mission = MissionState(k=state.mission_k,
                                   past_psied=state.past_psied,
                                   active=state.active)
            mission, frame = waypoint_manager(mission, waypoints, n_wp,
                                              meas.nedx, meas.nedy)
        with span("fleet.perceive"):
            slots = obs.perceive(obstacle_field, field_valid, meas.nedx,
                                 meas.nedy, meas.psi)
        with span("fleet.pack"):
            x0 = GuidanceController._pack_x0(
                meas, mission.past_psied, frame.ye, frame.ak)  # (B, nx)
            # the vehicle axis -> minor-most
            args = (to_lanes(x0), to_lanes(slots.p_obs),
                    to_lanes(slots.r_obs))

        # --- lane-engine solve ---
        with span("fleet.solve"):
            solver_state, out = self.solver.step_fn(state.solver, *args)

        with span("fleet.plant"):
            u0 = from_lanes(out.u0)[:, 0]                      # (B,)
            x1 = from_lanes(out.x1)                            # (B, nx)
            psi_d = wrap_once(x1[:, IPSIED] + frame.ak)
            active = mission.active
            past_psied = torch.where(active, x1[:, IPSIED],
                                     mission.past_psied)
            # integrate guidance kinematics; perfect speed loop
            with span("fleet.integrate"):
                x_next = self._plant(x0, u0[:, None], self._params0)
            meas_next = Measurements(u=frame.u_d, v=x_next[:, 1],
                                     nedx=x_next[:, 5], nedy=x_next[:, 6],
                                     psi=x_next[:, 7])
            new_state = FleetState(mission_k=mission.k,
                                   past_psied=past_psied, active=active,
                                   solver=solver_state, meas=meas_next)
        with span("fleet.log"):
            log = (torch.stack([meas.nedx, meas.nedy], dim=-1), frame.ye,
                   psi_d, active, slots.collision.any(dim=-1),
                   out.status.clone())
        return new_state, log

    # ------------------------------------------------------------------
    def run(self, meas0: Measurements, waypoints, n_wp,
            obstacle_field, field_valid, n_steps: int = 1200) -> FleetLog:
        waypoints = self._tensor(waypoints)
        n_wp = self._tensor(n_wp, torch.int32)
        obstacle_field = self._tensor(obstacle_field)
        field_valid = self._tensor(field_valid, torch.bool)
        state = self.init_state(meas0, waypoints, n_wp)
        logs = []
        for _ in range(n_steps):
            state, log = self.tick(state, waypoints, n_wp, obstacle_field,
                                   field_valid)
            logs.append(log)
        return FleetLog(*(torch.stack(f) for f in zip(*logs)), final=state)
