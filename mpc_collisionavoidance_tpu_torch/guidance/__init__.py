"""Guidance layer: the control logic of the reference C++ nodes as tensor
ticks (counterpart of `mpc_collisionavoidance_tpu/guidance`)."""

from mpc_collisionavoidance_tpu_torch.guidance.controller import (  # noqa: F401
    Commands, GuidanceController, GuidanceState, Measurements)
from mpc_collisionavoidance_tpu_torch.guidance.nodes import (  # noqa: F401
    PFCommands, PFController, PFMeasurements, PFState,
    ThrustMPCCommands, ThrustMPCController, ThrustMPCState,
    ThrustMeasurements)
from mpc_collisionavoidance_tpu_torch.guidance.obstacles import (  # noqa: F401
    ObstacleSlots, intake, lidar_scan, perceive)
from mpc_collisionavoidance_tpu_torch.guidance.waypoints import (  # noqa: F401
    MissionState, SegmentFrame, mission_init, waypoint_manager)
