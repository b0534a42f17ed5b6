"""Wrapper of the CUDA Riccati sweep `csrc/riccati_lanes.cu` (K1; the
kernels are `csrc/riccati_lanes.cuh` and `csrc/riccati_cta.cuh`).

Replaces `mpc_collisionavoidance_tpu/kernels/riccati_pallas.py::
lqr_solve_lanes_pallas`.  The wrapper checks device, dtype, shapes and
contiguity, allocates the outputs and the K/k scratch with `torch.empty`,
launches on the current stream and raises on a launch error.  It takes
CUDA tensors only; `ops.riccati_lanes.lqr_solve_lanes` sends CPU tensors
to the plain sweep.

K1 has two designs, and the launch picks one from the lane count and the
card (`csrc/riccati_lanes.cuh`): `"cta"`, a CTA per lane, for nu <= 2 up
to one CTA per SM (`cta_lanes`), else `"warp"`, a warp per lane.
`launches` counts kernel launches and `launches_by_design` the same
launches by design (with the tracer on, also the counters `k1.warp` and
`k1.cta`); a captured graph's replays add to `launches` only
(`solver/capture.py`), so in a capture these say which design the graph
holds.
"""

import ctypes

import torch

from mpc_collisionavoidance_tpu_torch.kernels import _build
from mpc_collisionavoidance_tpu_torch.utils import profiling

# (nx, nu) pairs the kernel is instantiated for (csrc/riccati_lanes.cuh's
# NMPC_K1_SHAPES): the flagship (8, 1), the 14-state hulls usv_pf_ca and
# usv_pf (14, 2), usv_low_level and usv_position_control (8, 2),
# usv_acados (5, 2), and the guidance family: usv_guidance_ca (9, 1),
# usv_guidance (10, 1), usv_guidance2 (12, 1), usv_guidance3 (11, 1),
# usv_guidance4 (4, 1), usv_guidance5 (5, 1), and the race car race_cars,
# race_cars_dev (6, 2); and the macro stages of partially condensed QPs
# (`ops/condense_partial.py`, nu' = M nu): the flagship at M = 4, 5, 10
# (8, 4), (8, 5), (8, 10) (its M = 2 is (8, 2)), usv_pf_ca at M = 2, 4
# (14, 4), (14, 8), race_cars_dev at M = 2 (6, 4)
SUPPORTED = ((8, 1), (14, 2), (8, 2), (5, 2), (9, 1), (10, 1), (12, 1),
             (11, 1), (4, 1), (5, 1), (6, 2), (8, 4), (8, 5), (8, 10),
             (14, 4), (14, 8), (6, 4))
DTYPES = (torch.float32, torch.float64)
# the designs, by their number in the C entries
DESIGNS = ("warp", "cta")

launches = 0
launches_by_design = dict.fromkeys(DESIGNS, 0)

_CTA_LANES = {}


def cta_lanes(device, dtype, nx, nu):
    """The most lanes the CTA design takes on `device` (one CTA per SM), 0
    for an instance without it (nu > 2); the C entries' rule."""
    key = (torch.device(device), dtype, nx, nu)
    if key not in _CTA_LANES:
        lanes = ctypes.c_int()
        with torch.cuda.device(key[0]):
            code = _build.library().nmpc_riccati_lanes_cta_lanes(
                int(dtype == torch.float64), nx, nu, ctypes.byref(lanes))
        _build.check(code, "riccati_lanes (occupancy)")
        _CTA_LANES[key] = lanes.value
    return _CTA_LANES[key]


def lqr_solve_lanes_cuda(A, B, c, Q, S, R, qx, qu, dx0):
    """(N, nx, nx, L) ... (nx, L) CUDA tensors -> (dx (N+1, nx, L),
    du (N, nu, L)), in the design the rule picks.  Same arguments as
    `LaneLQR`."""
    return _solve(None, A, B, c, Q, S, R, qx, qu, dx0)


def lqr_solve_lanes_cuda_as(design, A, B, c, Q, S, R, qx, qu, dx0):
    """The same in `design` ("warp" or "cta") whatever the rule picks: for
    the tests and timings that hold the designs side by side."""
    if design not in DESIGNS:
        raise ValueError(f"riccati kernel: design {design!r} not in "
                         f"{DESIGNS}")
    return _solve(design, A, B, c, Q, S, R, qx, qu, dx0)


def _solve(design, A, B, c, Q, S, R, qx, qu, dx0):
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
    if design == "cta" and nu > 2:
        raise ValueError(f"riccati kernel: no CTA design for nu = {nu}")

    lib = _build.library()
    dx = torch.empty((N + 1, nx, L), dtype=A.dtype, device=A.device)
    du = torch.empty((N, nu, L), dtype=A.dtype, device=A.device)
    K = torch.empty((N, nu, nx, L), dtype=A.dtype, device=A.device)
    k = torch.empty((N, nu, L), dtype=A.dtype, device=A.device)
    args = (int(A.dtype == torch.float64), nx, nu, N, L,
            *_build.launch_args(A.device, A, B, c, Q, S, R, qx, qu, dx0, dx,
                                du, K, k))
    if design is None:
        design = ("cta" if L <= cta_lanes(A.device, A.dtype, nx, nu)
                  else "warp")
        code = lib.nmpc_riccati_lanes(*args)
    else:
        code = lib.nmpc_riccati_lanes_as(DESIGNS.index(design), *args)
    _build.check(code, "riccati_lanes")
    launches += 1
    launches_by_design[design] += 1
    profiling.count(f"k1.{design}")
    return dx, du
