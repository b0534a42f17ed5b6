"""mpc_collisionavoidance_tpu_torch — the PyTorch/CUDA port of
`mpc_collisionavoidance_tpu`, for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module paths
and names so each counterpart is found at once.  It imports `torch` and
numpy, never `jax` and never the JAX package (whose `__init__` pulls in
jax), so the pure-numpy pieces (`ocp/spec.py`, `sim/scenarios.py`) are
copies.

Ported: the lane engine's RTI tick on every model of the JAX package's
zoo, its real-time server, and all three of its TPU kernels:

models   : Model container + every model's dynamics/constraints in torch
ocp      : OCPSpec and the builders
sim      : the scenarios
utils    : the race track (table, curvature interpolant, transforms)
ops      : lane algebra, the Riccati sweep, the fused linearization and
           the lane primal-dual IPM (plain PyTorch versions + dispatch)
kernels  : hand-written CUDA kernels for sm_90a (Riccati sweep, fused
           linearization, fused IPM), built with nvcc at first use and
           bound by ctypes
solver   : LaneRTISolver (lane layout, instance axis minor-most)
config   : SolverConfig and the production schedule
rt       : the real-time server and its frames
interop  : numpy carry-over of QPs / LQRs / warm starts from the JAX package

Device picks the path: CUDA tensors run the kernels, CPU tensors the plain
PyTorch versions.  No flag swaps one for the other.
"""

__version__ = "0.1.0"
