"""K1's CUDA source run on the CPU, against the plain sweep.

`csrc/riccati_lanes.cu`, its instance files `riccati_lanes_*.cu`,
`csrc/riccati_lanes.cuh`, `csrc/riccati_cta.cuh` and
`csrc/riccati_team.cuh` are compiled with g++ against the stand-in header
of tests/torch_cuda_emulation.py (a std::thread per CUDA thread, one
barrier per block, cp.async as a plain copy).  This checks the kernels'
indexing where no card exists.  The warp design: the tile ring, the
warp's rows and column parts, the transposed tiles, the 16-byte and
element copies, the ragged last block and a NaN lane, for every instance
(`kernels/riccati.py::SUPPORTED`) in both precisions.  The CTA design
(a CTA of up to 256 threads per lane, so only two instances): the
phases' entries, P's upper triangle, the 16-, 8- and 4-byte pieces of
L = 1 and the strided ones of L > 1, both rings at short horizons, warp
0's forward rollout after the other warps have left, and the rule's pick
through the stand-in's occupancy.
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
        ["riccati_team.cuh", "riccati_cta.cuh", "riccati_lanes.cuh"],
        ["riccati_lanes.cu", *(p.name for p in sorted(
            _build.CSRC.glob("riccati_lanes_*.cu")))],
        ["nmpc_riccati_lanes", "nmpc_riccati_lanes_as",
         "nmpc_riccati_lanes_cta_lanes"])


def _run(lib, d, design="warp"):
    """K1 on `d` in `design` ("warp", "cta", or None for the rule's)."""
    N, nx, _, L = d.A.shape
    nu = d.B.shape[2]
    opts = dict(dtype=d.A.dtype)
    dx, du = torch.empty(N + 1, nx, L, **opts), torch.empty(N, nu, L, **opts)
    K, k = torch.empty(N, nu, nx, L, **opts), torch.empty(N, nu, L, **opts)
    args = (int(d.A.dtype == torch.float64), nx, nu, N, L,
            *(ctypes.c_void_p(t.data_ptr()) for t in (*d, dx, du, K, k)),
            None)
    if design is None:
        code = lib.nmpc_riccati_lanes(*args)
    else:
        code = lib.nmpc_riccati_lanes_as(riccati.DESIGNS.index(design),
                                         *args)
    assert code == 0
    return dx, du


def _lqr(nx, nu, L, dtype, seed, N=7):
    return LaneLQR(*(torch.tensor(a, dtype=dtype)
                     for a in random_lqr(N=N, nx=nx, nu=nu, L=L, seed=seed)))


def _check(lib, d, design="warp"):
    rtol, atol = ((2e-4, 2e-5) if d.A.dtype == torch.float32
                  else (0.0, 1e-10))
    for g, w in zip(_run(lib, d, design), lqr_solve_lanes_plain(d)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


INSTANCES = list(riccati.SUPPORTED)


@pytest.mark.parametrize("L", [1, 6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu", INSTANCES)
def test_emulated_kernel_matches_plain(emulated, nx, nu, dtype, L):
    """The warp design.  L=1 and 6: ragged last blocks (element copies in
    float32, 16-byte copies in float64 at L=6); L=8: whole blocks, 16-byte
    copies."""
    _check(emulated, _lqr(nx, nu, L, dtype, seed=nx + L))


@pytest.mark.parametrize("N", [1, 2, 20])
@pytest.mark.parametrize("nx,nu", INSTANCES)
def test_emulated_kernel_matches_plain_at_short_horizons(emulated, nx, nu,
                                                         N):
    """The warp design at N=20 (the horizon of usv_acados and
    usv_position_control), and N=1 and 2, shorter than the backward ring's
    prefetch (kRing - 1 = 2 stages) and the forward ring (4 tiles at
    (5, 2), 5 at (8, 2)): the first and last stages of both rings, for
    every instance."""
    _check(emulated, _lqr(nx, nu, 5, torch.float64, seed=N, N=N))


@pytest.mark.parametrize("nx,nu", INSTANCES)
def test_emulated_kernel_nan_lane_leaves_the_others_bitwise(emulated, nx,
                                                            nu):
    """The warp design: lane 5 shares its block with lane 4."""
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


# the CTA design: the hull's (14, 2) (256 threads) and the flagship's
# (8, 1) (96 threads)
CTA_INSTANCES = [(14, 2), (8, 1)]


@pytest.mark.parametrize("L,N", [(1, 12), (3, 12), (1, 2), (2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu", CTA_INSTANCES)
def test_emulated_cta_kernel_matches_plain(emulated, nx, nu, dtype, L, N):
    """Through the rule's entry (one lane per block, up to the stand-in's
    132 SMs): L=1, whose fields are contiguous (16-byte,
    8-byte and, for a float32 field of odd length or address, element
    copies), and L=2, 3 (copies L apart); N=12 wraps the backward ring (4
    tiles) and the forward ring (7 tiles at (14, 2) float32), N=1 and 2
    are shorter than either's prefetch."""
    d = _lqr(nx, nu, L, dtype, seed=nx + 10 * L + N, N=N)
    assert _design(emulated, d) == "cta"
    _check(emulated, d, design=None)


@pytest.mark.parametrize("nx,nu", CTA_INSTANCES)
def test_emulated_cta_kernel_nan_lane_leaves_the_others_bitwise(emulated,
                                                                nx, nu):
    L, lane = 3, 1
    d = _lqr(nx, nu, L, torch.float32, seed=4)
    ref = _run(emulated, d, "cta")
    A = d.A.clone()
    A[..., lane] = float("nan")
    got = _run(emulated, d._replace(A=A), "cta")
    keep = np.arange(L) != lane
    for g, r in zip(got, ref):
        assert torch.equal(g[..., keep], r[..., keep])
    assert not torch.isfinite(got[0][..., lane]).all()


def _design(lib, d):
    """The design the rule picks for `d`: "cta" up to the lanes the C
    entry reports for the instance."""
    nx, nu, L = d.A.shape[1], d.B.shape[2], d.A.shape[3]
    lanes = ctypes.c_int()
    assert lib.nmpc_riccati_lanes_cta_lanes(
        int(d.A.dtype == torch.float64), nx, nu, ctypes.byref(lanes)) == 0
    return "cta" if L <= lanes.value else "warp"


@pytest.mark.parametrize("nx,nu", INSTANCES)
def test_emulated_rule_gives_the_cta_design_one_cta_per_sm(emulated, nx,
                                                           nu):
    """The stand-in's card has 132 SMs: the rule gives nu <= 2 instances
    the CTA design up to L = 132, and the wide ones (nu > 2) never; an
    instance K1 lacks reports -1."""
    lanes = ctypes.c_int()
    for is_double in (0, 1):
        assert emulated.nmpc_riccati_lanes_cta_lanes(
            is_double, nx, nu, ctypes.byref(lanes)) == 0
        assert lanes.value == (132 if nu <= 2 else 0)
    assert emulated.nmpc_riccati_lanes_cta_lanes(
        0, 7, 3, ctypes.byref(lanes)) == -1
