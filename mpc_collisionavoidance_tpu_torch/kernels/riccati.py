"""Wrapper of the CUDA Riccati sweep `csrc/riccati_lanes.cu` (K1; the
kernel is `csrc/riccati_lanes.cuh`).

Replaces `mpc_collisionavoidance_tpu/kernels/riccati_pallas.py::
lqr_solve_lanes_pallas`.  The wrapper checks device, dtype, shapes and
contiguity, allocates the outputs and the K/k scratch with `torch.empty`,
launches on the current stream and raises on a launch error.  It takes
CUDA tensors only; `ops.riccati_lanes.lqr_solve_lanes` sends CPU tensors
to the plain sweep.  `launches` counts kernel launches.
"""

import torch

from mpc_collisionavoidance_tpu_torch.kernels import _build

# (nx, nu) pairs the kernel is instantiated for (csrc/riccati_lanes.cuh's
# NMPC_K1_SHAPES): the flagship (8, 1), the 14-state hulls usv_pf_ca and
# usv_pf (14, 2), usv_low_level and usv_position_control (8, 2),
# usv_acados (5, 2), and the guidance family: usv_guidance_ca (9, 1),
# usv_guidance (10, 1), usv_guidance2 (12, 1), usv_guidance3 (11, 1),
# usv_guidance4 (4, 1), usv_guidance5 (5, 1), and the race car race_cars,
# race_cars_dev (6, 2)
SUPPORTED = ((8, 1), (14, 2), (8, 2), (5, 2), (9, 1), (10, 1), (12, 1),
             (11, 1), (4, 1), (5, 1), (6, 2))
DTYPES = (torch.float32, torch.float64)

launches = 0


def lqr_solve_lanes_cuda(A, B, c, Q, S, R, qx, qu, dx0):
    """(N, nx, nx, L) ... (nx, L) CUDA tensors -> (dx (N+1, nx, L),
    du (N, nu, L)).  Same arguments as `LaneLQR`."""
    global launches
    N, nx, _, L = A.shape
    nu = B.shape[2]
    _build.check_inputs(
        "riccati kernel",
        dict(A=A, B=B, c=c, Q=Q, S=S, R=R, qx=qx, qu=qu, dx0=dx0),
        {"A": (N, nx, nx, L), "B": (N, nx, nu, L), "c": (N, nx, L),
         "Q": (N + 1, nx, nx, L), "S": (N, nu, nx, L), "R": (N, nu, nu, L),
         "qx": (N + 1, nx, L), "qu": (N, nu, L), "dx0": (nx, L)},
        DTYPES)
    if (nx, nu) not in SUPPORTED:
        raise ValueError(f"riccati kernel: no instance for (nx, nu) = "
                         f"({nx}, {nu}); instantiated: {SUPPORTED}")

    lib = _build.library()
    dx = torch.empty((N + 1, nx, L), dtype=A.dtype, device=A.device)
    du = torch.empty((N, nu, L), dtype=A.dtype, device=A.device)
    K = torch.empty((N, nu, nx, L), dtype=A.dtype, device=A.device)
    k = torch.empty((N, nu, L), dtype=A.dtype, device=A.device)
    code = lib.nmpc_riccati_lanes(
        int(A.dtype == torch.float64), nx, nu, N, L,
        *_build.launch_args(A.device, A, B, c, Q, S, R, qx, qu, dx0, dx, du,
                            K, k))
    _build.check(code, "riccati_lanes")
    launches += 1
    return dx, du
