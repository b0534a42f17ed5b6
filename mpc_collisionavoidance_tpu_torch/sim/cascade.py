"""Cascaded two-solver closed loop: guidance NMPC -> low-level NMPC -> hull
(counterpart of `mpc_collisionavoidance_tpu/sim/cascade.py`).

The reference runs this as two ROS processes at different rates — the
guidance CA node at 20 Hz publishing /guidance/desired_{heading,speed} and
the low-level node at 100 Hz publishing thruster commands (SURVEY.md
section 3.5).  Here the cascade is one loop over 20 Hz guidance ticks whose
body runs GUIDANCE_SUBTICKS (=5) inner low-level ticks + plant
integrations: the rates are encoded in the loop structure, not in wall
clocks.

The plant is the true 3-DOF hydrodynamic hull (SURVEY.md section 2.4
coefficients via models/hydro.py): state (psi, u, v, r, nedx, nedy),
inputs the commanded thrusts, integrated with RK4 at the 100 Hz step.
Thrusters are modeled as tracking the commanded setpoint within a tick,
matching the reference sim's treatment (the thrust-rate dynamics live
inside the low-level OCP model itself).
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.guidance.controller import (
    GuidanceController, Measurements)
from mpc_collisionavoidance_tpu_torch.guidance.low_level import (
    THRUST_C, LowLevelController, LowLevelMeasurements)
from mpc_collisionavoidance_tpu_torch.models import hydro
from mpc_collisionavoidance_tpu_torch.ops.integrators import rk4_step

GUIDANCE_SUBTICKS = 5   # 100 Hz inner loop / 20 Hz guidance loop


class HullState(NamedTuple):
    """True vehicle state for the cascaded sim."""
    psi: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    r: torch.Tensor
    nedx: torch.Tensor
    nedy: torch.Tensor


def hull_dynamics(x, thrust, p):
    """(psi, u, v, r, nedx, nedy)' under thrusts (Tport, Tstbd), c = 0.78;
    state-first, as the port's models (`models/base.py`): x (6, ...),
    thrust (2, ...); `p` is unused."""
    psi, u, v, r = x[0], x[1], x[2], x[3]
    tu, tr = hydro.thrust_map(thrust[0], thrust[1], THRUST_C)
    du, dv, dr = hydro.uvr_dot(u, v, r, tu, tr)
    return torch.stack([
        r, du, dv, dr,
        u * torch.cos(psi) - v * torch.sin(psi),
        u * torch.sin(psi) + v * torch.cos(psi),
    ])


class CascadeLog(NamedTuple):
    pos: torch.Tensor        # (T, 2) at the guidance rate
    psi: torch.Tensor        # (T,)
    u: torch.Tensor          # (T,) surge speed
    psi_d: torch.Tensor      # (T,) guidance heading command
    u_d: torch.Tensor        # (T,)
    thrust: torch.Tensor     # (T, 2) port/stbd at tick end
    ye: torch.Tensor         # (T,)
    active: torch.Tensor     # (T,)
    collision: torch.Tensor  # (T,)


def run_cascade(gctrl: GuidanceController,
                llctrl: LowLevelController,
                hull0: HullState,
                waypoints, n_wp,
                obstacle_field, field_valid,
                n_steps: int = 1200,
                ll_dt: float = 0.01) -> CascadeLog:
    """Run the full cascade for `n_steps` guidance (20 Hz) ticks on the
    guidance controller's device and dtype (the JAX function's `dtype`
    argument is dropped; both controllers must share them)."""
    if (gctrl.device, gctrl.dtype) != (llctrl.device, llctrl.dtype):
        raise ValueError("the two controllers run on different devices "
                         "or dtypes")
    t = gctrl._tensor
    waypoints = t(waypoints)
    obstacle_field = t(obstacle_field)
    field_valid = torch.as_tensor(field_valid, dtype=torch.bool,
                                  device=gctrl.device)
    n_wp = torch.as_tensor(n_wp, dtype=torch.int32, device=gctrl.device)
    h = HullState(*(t(v) for v in hull0))
    no_params = t(torch.zeros(0))

    def hull_meas(h: HullState) -> Measurements:
        return Measurements(u=h.u, v=h.v, nedx=h.nedx, nedy=h.nedy, psi=h.psi)

    gstate = gctrl.init_state(hull_meas(h), waypoints, n_wp)
    llstate = llctrl.init_state(
        LowLevelMeasurements(psi=h.psi, u=h.u, v=h.v, r=h.r))

    logs = []
    for _ in range(n_steps):
        gstate, gcmds = gctrl.tick(gstate, hull_meas(h), waypoints, n_wp,
                                   obstacle_field, field_valid)
        # inner 100 Hz loop: solve low-level, apply thrust, integrate hull
        for _ in range(GUIDANCE_SUBTICKS):
            llmeas = LowLevelMeasurements(psi=h.psi, u=h.u, v=h.v, r=h.r)
            llstate, tcmds = llctrl.tick(llstate, llmeas,
                                         gcmds.psi_d, gcmds.u_d)
            thrust = torch.stack([tcmds.t_port, tcmds.t_stbd])
            xh = torch.stack([h.psi, h.u, h.v, h.r, h.nedx, h.nedy])
            xh = rk4_step(hull_dynamics, xh, thrust, no_params, ll_dt)
            h = HullState(*xh)
        logs.append((torch.stack([h.nedx, h.nedy]), h.psi, h.u,
                     gcmds.psi_d, gcmds.u_d, thrust, gcmds.ye,
                     gcmds.active, gcmds.collision))
    return CascadeLog(*(torch.stack(f) for f in zip(*logs)))
