"""Wrapper of the CUDA fused whole-IPM solve `csrc/ipm_lanes.cu` (K3).

Replaces `mpc_collisionavoidance_tpu/kernels/ipm_pallas.py::
fused_ipm_lanes`.  One launch runs all `iters` fixed-sigma iterations of
the lane IPM for every lane, one warp per lane (the design is in
`csrc/ipm_lanes.cuh`).  The wrapper checks device, dtype, shapes and
contiguity, allocates the outputs and the kernel's per-lane scratch (the
Newton step's cb, K, k) with `torch.empty`, launches on the current
stream and raises on a launch error or a horizon too long for the
kernel's shared memory.  The kernel is specialised per structure (nx, nu, nbu, nbx, nHh,
nS); `STRUCTURES` lists the instances, and any other structure raises.  It
takes CUDA tensors only; `ops.ipm_lanes.ipm_solve_lanes(riccati="fused")`
sends CPU tensors to the plain version `fused_ipm_lanes_plain`.  The
kernel builds the stage-0 state-box mask itself (s > 0), which is the
`xmask` every LaneQP of the solver carries.  `launches` counts kernel
launches.
"""

import ctypes

import torch

from mpc_collisionavoidance_tpu_torch.kernels import _build

# (nx, nu, nbu, nbx, nHh, nS) instantiated (csrc/ipm_lanes.cuh's
# NMPC_K3_STRUCTURES): the flagship usv_guidance_ca1, the hull usv_pf_ca,
# usv_pf, usv_low_level with usv_position_control, usv_acados, the
# guidance family usv_guidance_ca, usv_guidance, usv_guidance2..5, and the
# race car race_cars (hard and soft rows) and race_cars_dev (soft rows
# only, the softened state box among them)
STRUCTURES = ((8, 1, 1, 0, 0, 8), (14, 2, 2, 5, 4, 0), (14, 2, 2, 5, 0, 0),
              (8, 2, 2, 5, 0, 0), (5, 2, 2, 5, 0, 0), (9, 1, 1, 1, 8, 0),
              (10, 1, 1, 3, 0, 0), (12, 1, 1, 1, 0, 0), (11, 1, 1, 1, 0, 0),
              (4, 1, 1, 0, 0, 0), (5, 1, 1, 1, 0, 0), (6, 2, 2, 1, 3, 2),
              (6, 2, 2, 0, 0, 6))
DTYPES = (torch.float32, torch.float64)

# LaneQP fields in the order of the C entry's pointer array
_LANE_FIELDS = ("A", "B", "c", "qx", "qu", "dx0", "ub_lo", "ub_hi", "xb_lo",
                "xb_hi", "Ch", "hh_lo", "hh_hi", "Cs", "hofs", "slh", "suh")
_STATIC_FIELDS = ("Qc", "QN", "Sc", "Rc", "zl", "Zl", "zu", "Zu", "lsh",
                  "ush")

launches = 0


def fused_ipm_lanes_cuda(qp, idxbu, idxbx, iters=12, tau=0.995, sigma=0.1,
                         mu0=1.0):
    """`qp` an `ops.ipm_lanes.LaneQP` of contiguous CUDA tensors ->
    (dx (N+1, nx, L), du (N, nu, L), gap (L,), eq_res (L,))."""
    global launches
    N, nx, nu, L = qp.B.shape[0], qp.A.shape[1], qp.B.shape[2], qp.B.shape[-1]
    idxbu = tuple(int(i) for i in idxbu)
    idxbx = tuple(int(i) for i in idxbx)
    nbu, nbx = len(idxbu), len(idxbx)
    nHh, nS = qp.Ch.shape[1], qp.Cs.shape[1]
    structure = (nx, nu, nbu, nbx, nHh, nS)
    if structure not in STRUCTURES:
        raise ValueError(f"fused IPM kernel: no instance for (nx, nu, nbu, "
                         f"nbx, nHh, nS) = {structure}; instantiated: "
                         f"{STRUCTURES}")
    if qp.Dh is not None or qp.Ds is not None:
        raise ValueError("fused IPM kernel: control-coupled rows (Dh/Ds) "
                         "are not supported")
    if not all(0 <= i < nu for i in idxbu) or \
            not all(0 <= i < nx for i in idxbx):
        raise ValueError(f"fused IPM kernel: idxbu {idxbu} / idxbx {idxbx} "
                         f"out of range for nu={nu}, nx={nx}")
    if N < 1 or L < 1 or iters < 0:
        raise ValueError(f"fused IPM kernel: empty problem N={N}, L={L}, "
                         f"iters={iters}")
    tensors = {f: getattr(qp, f) for f in _LANE_FIELDS + _STATIC_FIELDS}
    _build.check_inputs(
        "fused IPM kernel", tensors,
        {"A": (N, nx, nx, L), "B": (N, nx, nu, L), "c": (N, nx, L),
         "qx": (N + 1, nx, L), "qu": (N, nu, L), "dx0": (nx, L),
         "ub_lo": (N, nbu, L), "ub_hi": (N, nbu, L),
         "xb_lo": (N, nbx, L), "xb_hi": (N, nbx, L),
         "Ch": (N, nHh, nx, L), "hh_lo": (N, nHh, L), "hh_hi": (N, nHh, L),
         "Cs": (N, nS, nx, L), "hofs": (N, nS, L), "slh": (N, nS, L),
         "suh": (N, nS, L),
         "Qc": (nx, nx), "QN": (nx, nx), "Sc": (nu, nx), "Rc": (nu, nu),
         **{f: (nS, 1) for f in ("zl", "Zl", "zu", "Zu", "lsh", "ush")}},
        DTYPES)

    lib = _build.library()
    slots = lib.nmpc_fused_ipm_scratch(*structure, N)
    if slots < 0:
        raise ValueError(f"fused IPM kernel: the library has no instance "
                         f"for {structure}")
    opts = dict(dtype=qp.A.dtype, device=qp.A.device)
    dx = torch.empty((N + 1, nx, L), **opts)
    du = torch.empty((N, nu, L), **opts)
    gap = torch.empty((L,), **opts)
    eq_res = torch.empty((L,), **opts)
    scratch = torch.empty((slots * L,), **opts)
    *ptrs, stream = _build.launch_args(
        qp.A.device, *tensors.values(), dx, du, gap, eq_res, scratch)
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    code = lib.nmpc_fused_ipm_lanes(
        int(qp.A.dtype == torch.float64), *structure, N, L, int(iters),
        float(tau), float(sigma), float(mu0),
        (ctypes.c_int * max(nbu, 1))(*idxbu),
        (ctypes.c_int * max(nbx, 1))(*idxbx), ptr_array, stream)
    if code == -3:
        raise ValueError(f"fused IPM kernel: the horizon N={N} does not fit "
                         "a block's shared memory")
    _build.check(code, "fused_ipm_lanes")
    launches += 1
    return dx, du, gap, eq_res
