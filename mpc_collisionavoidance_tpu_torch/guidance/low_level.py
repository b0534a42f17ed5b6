"""Inner-loop speed + heading NMPC: the reference `nmpc_low_level` node
(counterpart of `mpc_collisionavoidance_tpu/guidance/low_level.py`).

Re-implements the 100 Hz thrust controller (reference
catkin_ws/src/nmpc_ca/src/nmpc_low_level.cpp) as a tick over the
usv_low_level OCP (8 states incl. the (sin psi, cos psi) heading embedding,
N = 100, Tf = 1 s):

- x0 packs INS feedback plus the CARRIED thrust commands past_Tport /
  past_Tstbd (reference :206-213 — thrusts are states because the inputs
  are thrust rates, so the node's own last command is fed back, not a
  measurement);
- the reference is driven by references: yref = (psi_d, sin psi_d,
  cos psi_d, u_d, 0...0) on every stage (reference :221-246);
- thrust commands come from the STAGE-1 state (reference :257-260), with a
  hard zero override when u_d == 0 (reference :262-265);
- Tx / Tz telemetry uses the c = 0.78 asymmetric thrust map
  (reference :292-293).

The per-stage reference needs the per-instance engine (`RTISolver`): the
lane engine takes one reference for all stages.
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.config import require_device
from mpc_collisionavoidance_tpu_torch.guidance.controller import stack_last
from mpc_collisionavoidance_tpu_torch.ocp.spec import OCPSpec
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import (RTISolver,
                                                             SolverState)

# usv_low_level state indices
IPSI, ISIN, ICOS, ISU, ISV, ISR, ITPORT, ITSTBD = range(8)
THRUST_C = 0.78   # starboard asymmetry (reference scripts/usv_low_level/usv_model.py:77)
BEAM = 0.41       # hull beam B (reference :76)


class LowLevelMeasurements(NamedTuple):
    psi: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    r: torch.Tensor


class ThrustCommands(NamedTuple):
    t_port: torch.Tensor
    t_stbd: torch.Tensor
    e_u: torch.Tensor      # speed error telemetry (reference :273-279)
    e_psi: torch.Tensor    # heading error telemetry
    tx: torch.Tensor       # surge force Tx = Tp + c*Ts (reference :292)
    tz: torch.Tensor       # yaw moment Tz = (Tp - c*Ts)*B/2 (reference :293)
    solver_status: torch.Tensor


class LowLevelState(NamedTuple):
    solver: SolverState
    past_t_port: torch.Tensor   # command memory (reference :268-269)
    past_t_stbd: torch.Tensor


class LowLevelController:
    def __init__(self, spec: OCPSpec, solver: RTISolver = None,
                 ipm_iters: int = 8, *, device="cuda", dtype=torch.float32):
        """`solver`: an `RTISolver` for `spec`; None builds one with
        `ipm_iters` on `device` in `dtype` (a CUDA device on a host
        without one raises ValueError)."""
        if spec.model.name != "usv_low_level":
            raise ValueError(f"LowLevelController runs usv_low_level, not "
                             f"{spec.model.name}")
        self.spec = spec
        self.solver = solver or RTISolver(
            spec, ipm_iters=ipm_iters, device=require_device(device),
            dtype=dtype)
        self.device, self.dtype = self.solver.device, self.solver.dtype

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def init_state(self, meas: LowLevelMeasurements) -> LowLevelState:
        """The state takes the solver's dtype (the JAX method's `dtype`
        argument is dropped)."""
        meas = LowLevelMeasurements(*(self._tensor(m) for m in meas))
        zero = torch.zeros_like(meas.psi)
        x0 = self._pack_x0(meas, zero, zero)
        return LowLevelState(solver=self.solver.init_state(x0),
                             past_t_port=zero, past_t_stbd=zero)

    @staticmethod
    def _pack_x0(meas: LowLevelMeasurements, past_t_port, past_t_stbd):
        return stack_last([meas.psi, torch.sin(meas.psi),
                           torch.cos(meas.psi), meas.u, meas.v, meas.r,
                           past_t_port, past_t_stbd])

    def tick(self, state: LowLevelState, meas: LowLevelMeasurements,
             psi_d, u_d):
        """One 100 Hz inner-loop tick -> thrust commands."""
        meas = LowLevelMeasurements(*(self._tensor(m) for m in meas))
        psi_d = self._tensor(psi_d)
        u_d = self._tensor(u_d)
        x0 = self._pack_x0(meas, state.past_t_port, state.past_t_stbd)

        head = stack_last([psi_d, torch.sin(psi_d), torch.cos(psi_d), u_d])
        yref = torch.cat([head, head.new_zeros(head.shape[:-1] + (6,))],
                         dim=-1)                         # v, r, T.., U..
        N = self.spec.N
        yref_stages = yref[..., None, :].expand(yref.shape[:-1] + (N, 10))
        yref_e = yref[..., :8]

        params = torch.zeros((self.spec.model.np_,), dtype=self.dtype,
                             device=self.device)
        solver_state, out = self.solver.step_fn(
            state.solver, x0, params, yref=yref_stages, yref_e=yref_e)

        # thrust from stage-1 state; zero override when commanded speed is 0
        stop = u_d == 0.0
        t_port = torch.where(stop, 0.0, out.x1[..., ITPORT])
        t_stbd = torch.where(stop, 0.0, out.x1[..., ITSTBD])

        cmds = ThrustCommands(
            t_port=t_port, t_stbd=t_stbd,
            e_u=u_d - meas.u, e_psi=psi_d - meas.psi,
            tx=t_port + THRUST_C * t_stbd,
            tz=(t_port - THRUST_C * t_stbd) * BEAM / 2.0,
            solver_status=out.status)
        new_state = LowLevelState(solver=solver_state,
                                  past_t_port=out.x1[..., ITPORT],
                                  past_t_stbd=out.x1[..., ITSTBD])
        return new_state, cmds
