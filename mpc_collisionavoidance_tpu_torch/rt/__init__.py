"""Real-time serving (counterpart of `mpc_collisionavoidance_tpu/rt/`):
the wire protocol and the lane-engine server."""
