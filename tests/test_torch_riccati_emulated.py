"""K1's CUDA source run on the CPU, against the plain sweep.

`csrc/riccati_lanes.cu`, its instance files `riccati_lanes_*.cu`,
`csrc/riccati_lanes.cuh` and `csrc/riccati_team.cuh` are compiled with g++
against the stand-in header of tests/torch_cuda_emulation.py (a
std::thread per CUDA thread, one barrier per block, cp.async as a plain
copy).  This checks the kernel's indexing where no card exists: the tile
ring, the warp's rows and column parts, the transposed tiles, the 16-byte
and element copies, the ragged last block and a NaN lane, for every
instance (`kernels/riccati.py::SUPPORTED`) in both precisions.
"""

import ctypes

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu_torch.kernels import _build, riccati
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
    LaneLQR, lqr_solve_lanes_plain)
from tests import torch_cuda_emulation as emulation
from tests.test_torch_riccati import random_lqr


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K1's C entry, built from the checkout's sources for the CPU."""
    return emulation.build(
        tmp_path_factory.mktemp("k1_emulated"),
        ["riccati_team.cuh", "riccati_lanes.cuh"],
        ["riccati_lanes.cu", *(p.name for p in sorted(
            _build.CSRC.glob("riccati_lanes_*.cu")))],
        ["nmpc_riccati_lanes"])


def _run(lib, d):
    N, nx, _, L = d.A.shape
    nu = d.B.shape[2]
    opts = dict(dtype=d.A.dtype)
    dx, du = torch.empty(N + 1, nx, L, **opts), torch.empty(N, nu, L, **opts)
    K, k = torch.empty(N, nu, nx, L, **opts), torch.empty(N, nu, L, **opts)
    code = lib.nmpc_riccati_lanes(
        int(d.A.dtype == torch.float64), nx, nu, N, L,
        *(ctypes.c_void_p(t.data_ptr()) for t in (*d, dx, du, K, k)), None)
    assert code == 0
    return dx, du


def _lqr(nx, nu, L, dtype, seed, N=7):
    return LaneLQR(*(torch.tensor(a, dtype=dtype)
                     for a in random_lqr(N=N, nx=nx, nu=nu, L=L, seed=seed)))


def _check(lib, d):
    rtol, atol = ((2e-4, 2e-5) if d.A.dtype == torch.float32
                  else (0.0, 1e-10))
    for g, w in zip(_run(lib, d), lqr_solve_lanes_plain(d)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


INSTANCES = list(riccati.SUPPORTED)


@pytest.mark.parametrize("L", [1, 6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu", INSTANCES)
def test_emulated_kernel_matches_plain(emulated, nx, nu, dtype, L):
    """L=1 and 6: ragged last blocks (element copies in float32, 16-byte
    copies in float64 at L=6); L=8: whole blocks, 16-byte copies."""
    _check(emulated, _lqr(nx, nu, L, dtype, seed=nx + L))


@pytest.mark.parametrize("N", [1, 2, 20])
@pytest.mark.parametrize("nx,nu", INSTANCES)
def test_emulated_kernel_matches_plain_at_short_horizons(emulated, nx, nu,
                                                         N):
    """N=20 (the horizon of usv_acados and usv_position_control), and N=1
    and 2, shorter than the backward ring's prefetch (kRing - 1 = 2
    stages) and the forward ring (4 tiles at (5, 2), 5 at (8, 2)): the
    first and last stages of both rings, for every instance."""
    _check(emulated, _lqr(nx, nu, 5, torch.float64, seed=N, N=N))


@pytest.mark.parametrize("nx,nu", INSTANCES)
def test_emulated_kernel_nan_lane_leaves_the_others_bitwise(emulated, nx,
                                                            nu):
    L, lane = 9, 5
    d = _lqr(nx, nu, L, torch.float32, seed=3)
    ref = _run(emulated, d)
    A = d.A.clone()
    A[..., lane] = float("nan")
    got = _run(emulated, d._replace(A=A))
    keep = np.arange(L) != lane
    for g, r in zip(got, ref):
        assert torch.equal(g[..., keep], r[..., keep])
    assert not torch.isfinite(got[0][..., lane]).all()
