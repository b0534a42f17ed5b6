"""Process groups and the global scenario mesh (counterpart of
`mpc_collisionavoidance_tpu/parallel/distributed.py`).

One process per device, the standard PyTorch arrangement: each rank runs
this same program on its own device (`cuda:LOCAL_RANK`), the scenario
batch axis is split over the ranks, and the only cross-rank traffic is
the collectives of `parallel/sharding.py` (the fleet metrics) and the
lane engine's stall-escalation predicate (`ops/ipm_lanes.py::Escalation`).

Usage on each rank (torchrun sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT; or pass them):

    from mpc_collisionavoidance_tpu_torch.parallel import distributed
    distributed.init()                      # no-op on a lone process
    mesh = distributed.global_scenario_mesh()
    # shard_batch / make_sharded_batch_solver as on one device

The backend is named, never switched: NCCL for CUDA devices (one GPU per
rank), gloo for the CPU.  gloo also runs CUDA tensors, eagerly: ranks that
share one GPU pass `backend="gloo"` and the device itself.  A mesh needs a
process group; on a lone process `make_mesh` starts a one-rank group over
an in-process store (no port, no network), so that its collectives are
real ones there too.
"""

from __future__ import annotations

import datetime
import os
from typing import TYPE_CHECKING, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

# torch.distributed.device_mesh and .tensor are imported where they are
# used: importing them takes ~1 s, which every import of the lane engine
# would pay
if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

# how long a rank waits in a collective before its process group fails
TIMEOUT = datetime.timedelta(seconds=300)
# the mesh's one axis, the scenario batch (JAX's "dp")
AXIS = "dp"


def process_count() -> int:
    """The ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: "cuda" without an index is `cuda:LOCAL_RANK`
    (LOCAL_RANK 0 if unset); anything else is taken as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def check_backend(backend: str, device: torch.device, local_ranks: int = 1):
    """Raise ValueError for a backend that cannot serve `device` with
    `local_ranks` ranks on this host: NCCL on the CPU, NCCL with more ranks
    than GPUs, a CUDA device on a host without one, an unknown backend."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend '{backend}' (nccl or gloo)")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"device '{device}': this host has no CUDA device "
                         "(torch.cuda.is_available() is False)")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL runs CUDA devices only, not '{device}'; "
                             "use backend='gloo' on the CPU")
        gpus = torch.cuda.device_count()
        if local_ranks > gpus or device.index >= gpus:
            raise ValueError(
                f"NCCL needs one GPU per rank: {local_ranks} rank(s) on a "
                f"host with {gpus} GPU(s) (device {device}); ranks that "
                "share a GPU run backend='gloo', eagerly")


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, *, device="cuda",
         backend: Optional[str] = None,
         timeout: datetime.timedelta = TIMEOUT) -> int:
    """Start this rank's process group; a no-op on a lone process.

    With no arguments it reads torchrun's RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT; `coordinator_address` is "host:port".  A lone process
    (`num_processes`, or else WORLD_SIZE, is 1 or unset) starts nothing,
    as JAX's `init` does (a mesh starts its own one-rank group).
    `device`: this rank's device (`rank_device`; pass the same to the
    mesh); `backend`: "nccl" or "gloo" (default: `default_backend(device)`),
    checked by `check_backend`; `timeout`: the process group's.
    Idempotent.  Returns the rank."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if num_processes == 1:
        return 0
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    device = rank_device(device)
    backend = backend or default_backend(device)
    check_backend(backend, device,
                  int(env.get("LOCAL_WORLD_SIZE", num_processes)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        rank=process_id, world_size=num_processes, timeout=timeout,
        device_id=device if backend == "nccl" else None)
    return dist.get_rank()


def _lone_group(device: torch.device):
    """A one-rank default process group over an in-process store."""
    backend = default_backend(device)
    check_backend(backend, device)
    dist.init_process_group(
        backend, store=dist.HashStore(), rank=0, world_size=1,
        timeout=TIMEOUT, device_id=device if backend == "nccl" else None)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh` (the current CUDA device for a CUDA
    mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(device="cuda") -> DeviceMesh:
    """The 1-D `"dp"` mesh over every rank of the default process group,
    one device per rank: this rank's is `rank_device(device)`.  Without a
    process group, starts a one-rank one (`default_backend(device)`)."""
    device = rank_device(device)
    if not dist.is_initialized():
        _lone_group(device)
    else:
        check_backend(dist.get_backend(), device)
    if device.type == "cuda":
        # the device current before the mesh is made is the mesh's (it
        # would otherwise pick cuda:LOCAL_RANK)
        torch.cuda.set_device(device)
        torch.cuda.init()
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, (dist.get_world_size(),),
                            mesh_dim_names=(AXIS,))


# JAX's name for the mesh over every device of every process; with one
# process per device it is `make_mesh`'s
global_scenario_mesh = make_mesh


def shard_batch_global(mesh: DeviceMesh, tree):
    """Each rank's LOCAL slice (B_local, ...) of every leaf of `tree` (a
    tensor or array; NamedTuples and tuples are walked) as one global
    `DTensor` of shape (B_local * ranks, ...), sharded along the batch
    axis over `mesh` (the slices must be equal).  The data stays where it
    is: no collective runs."""
    from torch.distributed.tensor import DTensor, Shard
    device = mesh_device(mesh)

    def put(x):
        return DTensor.from_local(torch.as_tensor(x, device=device), mesh,
                                  [Shard(0)], run_check=False)

    return pytree.tree_map(put, tree)


def per_process_batch(global_batch: int) -> int:
    """This rank's share of a global scenario count (equal shards; the
    global batch must divide evenly, for fixed shapes)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n

