"""Mission-level closed-loop simulation: the multi-node ROS graph in one
process (counterpart of `mpc_collisionavoidance_tpu/sim/mission.py`).

The reference tests its guidance stack by running three processes — the
`obstacle_sim_node` fake LiDAR (reference
catkin_ws/src/simulation/scripts/obstacle_sim_node.py), the
`nmpc_guidance_ca1` node, and an external autopilot — wired over TCPROS at
20 Hz (SURVEY.md section 4.2).  Here perception, mission management, the
RTI solve and the plant step compose per tick in one loop.

The plant integrates the guidance kinematics (usv_guidance_ca1 dynamics,
T1 = 1 s heading response standing in for the inner loop / ASMC of the
2024 paper) with the commanded psi_e_d rate, and tracks the commanded
surge speed through a perfect speed loop (u <- u_d), which lets missions
actually stop at the final waypoint — the reference's kinematic model has
no surge dynamics at all (u_dot = 0, reference
scripts/usv_guidance_ca1/usv_model.py:117-128).
"""

from typing import NamedTuple

import torch

from mpc_collisionavoidance_tpu_torch.guidance.controller import (
    Commands, GuidanceController, GuidanceState, Measurements)
from mpc_collisionavoidance_tpu_torch.ops import integrators


class MissionLog(NamedTuple):
    pos: torch.Tensor       # (T, ..., 2) NED track
    psi: torch.Tensor       # (T, ...)
    cmds: Commands          # per-tick command streams (leading T axis)
    final_state: GuidanceState


def run_mission(controller: GuidanceController,
                meas0: Measurements,
                waypoints, n_wp,
                obstacle_field, field_valid,
                n_steps: int = 1200) -> MissionLog:
    """Run one mission end to end on the controller's device and dtype
    (the JAX function's `dtype` argument is dropped).  With an `RTISolver`
    whose inputs carry a batch axis, the missions of a batch run together
    and the log's axes are (T, B, ...)."""
    spec = controller.spec
    plant_step = integrators.make_discrete_dynamics(
        spec.model.f, spec.dt, num_steps=4)
    t = controller._tensor
    waypoints = t(waypoints)
    obstacle_field = t(obstacle_field)
    field_valid = torch.as_tensor(field_valid, dtype=torch.bool,
                                  device=controller.device)
    n_wp = torch.as_tensor(n_wp, dtype=torch.int32, device=controller.device)
    meas = controller.measurements(meas0)
    st = controller.init_state(meas, waypoints, n_wp)
    params0 = t(torch.zeros(spec.model.np_))     # dynamics ignore p

    pos, psi, cmds_log = [], [], []
    for _ in range(n_steps):
        st, cmds = controller.tick(st, meas, waypoints, n_wp,
                                   obstacle_field, field_valid)
        pos.append(torch.stack([meas.nedx, meas.nedy], dim=-1))
        psi.append(meas.psi)
        cmds_log.append(cmds)
        # honest plant: integrate the guidance kinematics one tick from the
        # controller-packed state with the commanded psi_e_d rate
        x_next = plant_step(cmds.x0, cmds.r_d[..., None], params0)
        meas = Measurements(
            u=cmds.u_d,                      # perfect inner speed loop
            v=x_next[..., 1],
            nedx=x_next[..., 5], nedy=x_next[..., 6], psi=x_next[..., 7])
    return MissionLog(pos=torch.stack(pos), psi=torch.stack(psi),
                      cmds=Commands(*(torch.stack(f)
                                      for f in zip(*cmds_log))),
                      final_state=st)


def min_obstacle_clearance(log: MissionLog, obstacle_field, field_valid):
    """Per-obstacle minimum center distance over the mission track: (M,),
    or (..., M) for a batch's log."""
    field = torch.as_tensor(obstacle_field, dtype=log.pos.dtype,
                            device=log.pos.device)
    d = torch.hypot(log.pos[..., None, 0] - field[..., 0],
                    log.pos[..., None, 1] - field[..., 1])   # (T, ..., M)
    d = d.min(dim=0).values
    valid = torch.as_tensor(field_valid, dtype=torch.bool, device=d.device)
    return torch.where(valid, d, torch.inf)
