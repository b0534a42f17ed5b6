"""Scenario parallelism over ranks, one process per device (counterpart of
`mpc_collisionavoidance_tpu/parallel/`): `sharding` (the mesh, the batch
and lane slices, the sharded per-instance step, the fleet metrics),
`distributed` (process groups, the global mesh) and `dryrun` (the
multi-device validation and its launcher)."""

from mpc_collisionavoidance_tpu_torch.parallel.sharding import (
    fleet_metrics, make_mesh, make_sharded_batch_solver, shard_batch)

__all__ = ["make_mesh", "make_sharded_batch_solver", "fleet_metrics",
           "shard_batch"]
