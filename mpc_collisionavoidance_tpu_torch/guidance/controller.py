"""The flagship guidance controller: the full node behavior as one tick
(counterpart of `mpc_collisionavoidance_tpu/guidance/controller.py`).

Composes the mission manager (`guidance/waypoints.py`), the obstacle
intake (`guidance/obstacles.py`) and an RTI solver into the complete
per-tick behavior of the reference `nmpc_guidance_ca1` node (reference
catkin_ws/src/nmpc_ca/src/nmpc_guidance_ca1.cpp, 20 Hz loop :606-640):

measurements + waypoint table + obstacle field
    -> waypoint_manager -> crab-angle state packing -> obstacle slots
    -> one SQP-RTI solve -> (psi_d, r_d, u_d, ye) commands.

The ROS pub/sub seams of the reference (velocity/position/waypoints/
obstacles callbacks :223-250, six publishers :172-184) become function
arguments and a returned `Commands` tuple; the node's mutable members
(`k`, `past_psied`, the solver warm start held inside acados) become the
explicit `GuidanceState` carry.  The solver is an `RTISolver` (whose
leading batch axes make the tick serve a batch of vehicles) or a
`LaneSolverAdapter` (one vehicle on the lane engine's captured tick).
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.config import require_device
from mpc_collisionavoidance_tpu_torch.guidance import obstacles as obs
from mpc_collisionavoidance_tpu_torch.guidance.waypoints import (
    MissionState, mission_init, waypoint_manager)
from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
from mpc_collisionavoidance_tpu_torch.utils.angles import wrap_once

# usv_guidance_ca1 state indices (reference state enum :80-93)
IU, IV, IYE, ICHIE, IPSIED, IXNED, IYNED, IPSI = range(8)


class Measurements(NamedTuple):
    """INS feedback (reference velocity/position callbacks :223-241):
    0-d tensors for one vehicle, (B,) for a fleet."""
    u: torch.Tensor
    v: torch.Tensor
    nedx: torch.Tensor
    nedy: torch.Tensor
    psi: torch.Tensor


class Commands(NamedTuple):
    """The node's published outputs (reference :587-600)."""
    psi_d: torch.Tensor       # desired heading = x1[psied] + ak, wrapped
    r_d: torch.Tensor         # desired yaw rate = u0 (psi_e_d rate)
    u_d: torch.Tensor         # desired speed (0.7 cruising / 0.0 done)
    ye: torch.Tensor          # cross-track error (telemetry)
    target: torch.Tensor      # (..., 2) current target waypoint
    collision: torch.Tensor   # any obstacle slot in collision
    solver_status: torch.Tensor
    active: torch.Tensor
    ak: torch.Tensor          # current segment angle (telemetry / plant)
    x0: torch.Tensor          # (..., 8) packed OCP initial state


class GuidanceState(NamedTuple):
    mission: MissionState
    solver: NamedTuple        # the solver's warm start
    psi_d_hold: torch.Tensor  # last published heading (held when inactive,
    r_d_hold: torch.Tensor    # mirroring the node going silent :487-490)


def stack_last(vals):
    """Broadcast the tensors against each other and stack them on a new
    last axis (the packed state of one vehicle or of a batch)."""
    return torch.stack(torch.broadcast_tensors(*vals), dim=-1)


class GuidanceController:
    """One vehicle's (or one batch's) guidance stack."""

    def __init__(self, spec: OCPSpec, solver=None, ipm_iters: int = 12, *,
                 device="cuda", dtype=torch.float32):
        """`solver`: an `RTISolver` or a `LaneSolverAdapter` for `spec`;
        None builds an `RTISolver` with `ipm_iters` on `device` in `dtype`
        (a CUDA device on a host without one raises ValueError).  The
        controller runs on its solver's device and dtype."""
        if spec.model.name != "usv_guidance_ca1":
            raise ValueError(f"GuidanceController runs usv_guidance_ca1, "
                             f"not {spec.model.name}")
        self.spec = spec
        self.solver = solver or RTISolver(
            spec, ipm_iters=ipm_iters, device=require_device(device),
            dtype=dtype)
        self.device, self.dtype = self.solver.device, self.solver.dtype

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def measurements(self, meas) -> Measurements:
        """Any five numbers or arrays -> Measurements on the device."""
        return Measurements(*(self._tensor(m) for m in meas))

    # ------------------------------------------------------------------
    def init_state(self, meas: Measurements, waypoints,
                   n_wp) -> GuidanceState:
        """Mission seed on a fresh waypoint list (reference :616-632).  The
        state takes the solver's dtype (the JAX method's `dtype` argument
        is dropped)."""
        meas = self.measurements(meas)
        mission = mission_init(self._tensor(waypoints), n_wp, meas.psi)
        zero = torch.zeros_like(meas.psi)
        x0 = self._pack_x0(meas, mission.past_psied, zero, zero)
        return GuidanceState(
            mission=mission,
            solver=self.solver.init_state(x0),
            psi_d_hold=meas.psi.clone(),
            r_d_hold=zero,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _pack_x0(meas: Measurements, past_psied, ye, ak):
        """Measurement -> OCP initial state (reference control() :495-512):
        crab angle beta = atan2(v, u) with the u == 0 -> 0.001 guard
        (velocityCallback :224-228), course error chie = psi + beta - ak
        wrapped once."""
        u = torch.where(meas.u == 0.0, 0.001, meas.u)
        beta = torch.atan2(meas.v, u)
        chie = wrap_once(meas.psi + beta - ak)
        return stack_last([u, meas.v, ye, chie, past_psied,
                           meas.nedx, meas.nedy, meas.psi])

    # ------------------------------------------------------------------
    def tick(self, state: GuidanceState, meas: Measurements,
             waypoints, n_wp, obstacle_field, field_valid):
        """One 20 Hz control tick (the body of the reference main loop)."""
        meas = self.measurements(meas)
        waypoints = self._tensor(waypoints)
        obstacle_field = self._tensor(obstacle_field)
        field_valid = torch.as_tensor(field_valid, dtype=torch.bool,
                                      device=self.device)
        mission, frame = waypoint_manager(
            state.mission, waypoints, n_wp, meas.nedx, meas.nedy)

        slots = obs.perceive(obstacle_field, field_valid,
                             meas.nedx, meas.nedy, meas.psi)

        x0 = self._pack_x0(meas, mission.past_psied, frame.ye, frame.ak)
        solver_state, out = self.solver.step_fn(
            state.solver, x0, slots.p_obs, slots.r_obs)

        # command extraction (reference :583-600): heading from the STAGE-1
        # predicted psi_e_d (input is at derivative level), rate from u0
        psi_d = wrap_once(out.x1[..., IPSIED] + frame.ak)
        r_d = out.u0[..., 0]
        active = mission.active

        mission = mission._replace(
            past_psied=torch.where(active, out.x1[..., IPSIED],
                                   mission.past_psied))
        psi_d_held = torch.where(active, psi_d, state.psi_d_hold)
        r_d_held = torch.where(active, r_d, state.r_d_hold)

        cmds = Commands(
            psi_d=psi_d_held, r_d=r_d_held, u_d=frame.u_d,
            ye=frame.ye, target=frame.target,
            collision=slots.collision.any(dim=-1),
            solver_status=out.status, active=active,
            ak=frame.ak, x0=x0,
        )
        new_state = GuidanceState(mission=mission, solver=solver_state,
                                  psi_d_hold=psi_d_held, r_d_hold=r_d_held)
        return new_state, cmds
