"""mpc_collisionavoidance_tpu_torch — the PyTorch/CUDA port of
`mpc_collisionavoidance_tpu`, for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module paths
and names so each counterpart is found at once.  It imports `torch` and
numpy, never `jax` and never the JAX package (whose `__init__` pulls in
jax), so the pure-numpy pieces (`ocp/spec.py`, `sim/scenarios.py`) are
copies.

Ported: the lane engine's RTI tick on every model of the JAX package's
zoo, the per-instance engine and its goldens, the real-time server on
both, the guidance nodes and their simulations, the experiment CLI, the
scenario-parallel layer, and all three of its TPU kernels:

models   : Model container + every model's dynamics/constraints in torch
ocp      : OCPSpec and the builders
guidance : the reference nodes as ticks: perception (LiDAR cull, top-8
           intake), waypoint manager, the flagship controller, the
           low-level, PF, thrust and variant nodes
sim      : the scenarios and world fields, the mission harness, the fleet
           mission engine, the closed-loop engine, the two-rate cascade
utils    : the race track (table, curvature interpolant, transforms) and
           the angle wraps
ops      : lane algebra, the Riccati sweep, the fused linearization and
           the lane primal-dual IPM (plain PyTorch versions + dispatch);
           the per-instance engine's integrators, Riccati solve, QP
           assembly, IPM and dense (condensed) QP path
kernels  : hand-written CUDA kernels for sm_90a (Riccati sweep, fused
           linearization, fused IPM), built with nvcc at first use and
           bound by ctypes
solver   : LaneRTISolver (lane layout, instance axis minor-most),
           LaneSolverAdapter (one vehicle on it) and RTISolver
           (per-instance shapes with leading batch axes)
parity   : the committed goldens, recomputed by RTISolver
config   : SolverConfig, the production schedule and FrameworkConfig
parallel : the scenario-parallel layer on torch.distributed (one process
           per device): meshes, batch and lane slices, the sharded
           per-instance step, fleet metrics as all-reduces, and
           dryrun_multichip with its launcher
rt       : the real-time server and its frames
interop  : numpy carry-over of QPs / LQRs / warm starts / mission, controller
           and fleet carries from the JAX package

Device picks the path: CUDA tensors run the kernels, CPU tensors the plain
PyTorch versions.  No flag swaps one for the other.
"""

__version__ = "0.1.0"
