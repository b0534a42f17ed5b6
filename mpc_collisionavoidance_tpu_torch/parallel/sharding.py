"""Scenario-batch data parallelism over a device mesh (counterpart of
`mpc_collisionavoidance_tpu/parallel/sharding.py`).

Each rank of a 1-D `"dp"` mesh (`torch.distributed.device_mesh`, one
process per device, `parallel/distributed.py`) holds an equal slice of the
scenario batch on its device and steps it on its own.  The solves are
independent per instance, so the only collectives are:

- the fleet-level reductions (`fleet_metrics`: converged share and max
  gap as all-reduce SUM and MAX; never a gather to one host);
- the lane engine's stall-escalation predicate, reduced over the mesh
  (MAX) before each escalation step, so that every rank runs the steps
  that JAX's sharded tick runs (`LaneRTISolver(...,
  group=mesh.get_group())`, `ops/ipm_lanes.py::Escalation`).

The per-instance batch rides the leading axis (`shard_batch`), the lane
engine's the minor-most lane axis (`shard_lanes`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

# the 1-D data-parallel mesh over the scenario batch axis: every rank of
# the process group, one device each
from mpc_collisionavoidance_tpu_torch.parallel.distributed import (
    make_mesh, mesh_device)  # noqa: F401
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def _slice(mesh: DeviceMesh, axis: int):
    """`put(x)`: this rank's equal slice of `x` along `axis`, a contiguous
    copy on the rank's device; an uneven split raises ValueError."""
    n = mesh.size()
    r = mesh.get_local_rank()
    device = mesh_device(mesh)

    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x))
        size = x.shape[axis]
        if size % n:
            raise ValueError(f"a batch of {size} does not split evenly over "
                             f"{n} devices")
        b = size // n
        return x.narrow(axis, r * b, b).to(
            device=device, memory_format=torch.contiguous_format, copy=True)

    return put


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's equal slice of every leaf of `tree` (a global batch,
    tensors or arrays with the batch axis leading; NamedTuples and tuples
    are walked), on this rank's device."""
    return pytree.tree_map(_slice(mesh, 0), tree)


def shard_lanes(mesh: DeviceMesh, tree):
    """`shard_batch` along the minor-most lane axis: the lane engine's
    layout (`solver/batch.py`), in which every leaf's last axis is the
    instance axis (the lane state, x0 (nx, L), params (np, L), lh (nh, L))."""
    return pytree.tree_map(_slice(mesh, -1), tree)


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def make_sharded_batch_solver(solver: RTISolver, mesh: DeviceMesh,
                              donate: bool = True):
    """The per-instance RTI step with the scenario axis sharded over
    `mesh`.

    Returns ``run(states, x0s, params, lhs=None) -> (states, outs)``: on
    each rank `solver.step` (which takes leading batch axes) on the local
    shard, which on a CUDA device replays the solver's captured step.
    Inputs are this rank's slices (`shard_batch`) or global `DTensor`s
    (`distributed.shard_batch_global`), and the outputs take the same
    form.  No collective runs: the solves are independent.  `donate` is
    JAX's argument: the step never writes its inputs, and what it returns
    is the caller's own (copied out of the captured program)."""
    device = mesh_device(mesh)
    if solver.device != device:
        raise ValueError(f"a solver on '{solver.device}' for a mesh whose "
                         f"rank runs '{device}'")

    from torch.distributed.tensor import DTensor, Shard

    def run(states, x0s, params, lhs=None):
        args = (states, x0s, params, lhs)
        leaves = pytree.tree_leaves(args)
        glob = any(isinstance(x, DTensor) for x in leaves)
        states, outs = solver.step(*pytree.tree_map(_local, args))
        if not glob:
            return states, outs
        return pytree.tree_map(
            lambda x: DTensor.from_local(x, mesh, [Shard(0)],
                                         run_check=False), (states, outs))

    return run


def fleet_metrics(mesh: DeviceMesh, statuses, gaps):
    """Global fleet health over every shard of `mesh` (the 'convergence
    voting' collective): the share of instances with status 0 (float32,
    as JAX's) and the largest gap, 0-d tensors equal on every rank.
    `statuses`, `gaps`: this rank's (or global `DTensor`s).  Always an
    all-reduce (SUM of the counts, MAX of the gap), one rank or many."""
    group = mesh.get_group()
    statuses, gaps = _local(statuses), _local(gaps)
    counts = torch.stack([(statuses == 0).sum(), torch.tensor(
        statuses.numel(), device=statuses.device)]).to(torch.float32)
    gmax = gaps.amax().clone()
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    return counts[0] / counts[1], gmax
