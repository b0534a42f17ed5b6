"""K3's CUDA source run on the CPU, against the plain fused IPM.

`csrc/ipm_lanes.cu`, its instance files, `csrc/ipm_lanes.cuh` and
`csrc/riccati_team.cuh` are compiled with g++ against the stand-in header
of tests/torch_cuda_emulation.py (a std::thread per CUDA thread, one
barrier per block, shuffles through the barrier, cp.async as a plain
copy).  QPs come from the fused solver's own assembly at each OCP's
default scenario (N=12, float64; the structures with no h rows, the hull
family's usv_pf, usv_low_level, usv_position_control, usv_acados and the
guidance family's usv_guidance, usv_guidance2..5, also at N=1, 2 and 20,
shorter than the tile rings, and the race car's two structures with soft
rows, hard rows beside them, and quadratic slack weights, at N=1, 2 and
20 too); the kernel's C entry is called as
`kernels/ipm.py` calls it, and its dx, du, gap and status are held against
`fused_ipm_lanes_plain`.  This checks the kernel's indexing where no card
exists: the shared-memory layout, the row units of the stage-parallel
passes, the stage tiles and the warp's Riccati step inside the IPM, the
per-lane scratch and the warp reductions.
"""

import ctypes

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu_torch.config import SolverConfig
from mpc_collisionavoidance_tpu_torch.kernels import _build, ipm
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
    contiguous_qp, fused_ipm_lanes_plain, lane_status)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
from tests import torch_cuda_emulation as emulation

N, ITERS, TOL = 12, 4, 1e-7
OCPS = ("usv_guidance_ca1", "usv_pf_ca", "usv_pf", "usv_low_level",
        "usv_position_control", "usv_acados", "usv_guidance_ca",
        "usv_guidance", "usv_guidance2", "usv_guidance3", "usv_guidance4",
        "usv_guidance5", "race_cars", "race_cars_dev")
# the OCPs with neither hard nor soft rows
NO_ROWS = tuple(n for n in OCPS if builders.build(n).model.nh == 0)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K3's C entries, built from the checkout's sources for the CPU."""
    return emulation.build(
        tmp_path_factory.mktemp("k3_emulated"),
        ["riccati_team.cuh", "ipm_lanes.cuh"],
        ["ipm_lanes.cu", *(p.name for p in sorted(
            _build.CSRC.glob("ipm_lanes_*.cu")))],
        ["nmpc_fused_ipm_lanes", "nmpc_fused_ipm_scratch"])


def _qp(name, L, N=N, dtype=torch.float64):
    """A LaneQP of the fused solver's assembly at the model's default
    scenario, its coordinate perturbed."""
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    spec = builders.build(name, N=N, **(
        {} if sc.track is None else {"track": sc.track}))
    m = spec.model
    rng = np.random.default_rng(L)
    x0s = np.broadcast_to(sc.x0, (L, m.nx)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(L)
    solver = SolverConfig(riccati="fused").build(spec, device="cpu",
                                                 dtype=dtype)
    lanes = [to_lanes(torch.tensor(np.asarray(a), dtype=dtype))
             for a in (x0s, np.broadcast_to(sc.params, (L, m.np_)),
                       np.broadcast_to(sc.lh, (L, m.nh)))]
    qp = contiguous_qp(solver._build_qp(solver.init_state(x0s), *lanes))
    return qp, solver.idxbu, solver.idxbx


def _run(lib, qp, idxbu, idxbx):
    """The C entry as kernels/ipm.py calls it, on CPU tensors."""
    N, nx, nu, L = qp.B.shape[0], qp.A.shape[1], qp.B.shape[2], \
        qp.B.shape[-1]
    structure = (nx, nu, len(idxbu), len(idxbx), qp.Ch.shape[1],
                 qp.Cs.shape[1])
    assert structure in ipm.STRUCTURES
    opts = dict(dtype=qp.A.dtype)
    dx, du = torch.empty(N + 1, nx, L, **opts), torch.empty(N, nu, L, **opts)
    gap, eq_res = torch.empty(L, **opts), torch.empty(L, **opts)
    slots = lib.nmpc_fused_ipm_scratch(*structure, N)
    assert slots == N * (nx + nu * nx + nu)
    scratch = torch.full((slots * L,), float("nan"), **opts)
    tensors = [getattr(qp, f) for f in ipm._LANE_FIELDS + ipm._STATIC_FIELDS]
    ptrs = [t.data_ptr() for t in (*tensors, dx, du, gap, eq_res, scratch)]
    code = lib.nmpc_fused_ipm_lanes(
        int(qp.A.dtype == torch.float64), *structure, N, L, ITERS, 0.995,
        0.1, 1.0,
        (ctypes.c_int * max(len(idxbu), 1))(*idxbu),
        (ctypes.c_int * max(len(idxbx), 1))(*idxbx),
        (ctypes.c_void_p * len(ptrs))(*ptrs), None)
    assert code == 0
    return dx, du, gap, eq_res


@pytest.mark.parametrize("L", [1, 5, 6])
@pytest.mark.parametrize("name", OCPS)
def test_emulated_kernel_matches_plain(emulated, name, L):
    qp, idxbu, idxbx = _qp(name, L)
    _check(emulated, qp, idxbu, idxbx)


@pytest.mark.parametrize("N", [1, 2, 20])
@pytest.mark.parametrize("name", NO_ROWS)
def test_emulated_kernel_matches_plain_at_short_horizons(emulated, name, N):
    """The structures with no h rows at N=20 (usv_acados' and
    usv_position_control's horizon), N=2 and N=1, shorter than the
    backward ring's prefetch and the forward ring; usv_guidance4's
    (4, 1, 1, 0, 0, 0) has no state box either (xb_lo, xb_hi (N, 0, L))."""
    qp, idxbu, idxbx = _qp(name, 3, N=N)
    assert qp.Ch.shape[1] == qp.Cs.shape[1] == 0
    _check(emulated, qp, idxbu, idxbx)


@pytest.mark.parametrize("N", [1, 2, 20])
@pytest.mark.parametrize("name", ["race_cars", "race_cars_dev"])
def test_emulated_race_structures_at_short_horizons(emulated, name, N):
    """The race car's structures: race_cars' (6, 2, 2, 1, 3, 2), the first
    with hard and soft row units together, and race_cars_dev's
    (6, 2, 2, 0, 0, 6), soft rows only, the softened state box among them,
    with quadratic slack weights Zl = Zu = 1 (scaled by dt = Tf / N,
    Tf = 1); at N=20, 2 and 1."""
    qp, idxbu, idxbx = _qp(name, 3, N=N)
    assert float(qp.Zl.min()) == (0.0 if name == "race_cars" else 1.0 / N)
    _check(emulated, qp, idxbu, idxbx)


@pytest.mark.parametrize("name", OCPS)
def test_emulated_kernel_matches_plain_in_float32(emulated, name):
    """The float32 instance of every structure at L=5: du within the
    float32 gap-floor ball that chip_smoke.py's phase 4 allows (5e-3),
    the same lanes converged."""
    qp, idxbu, idxbx = _qp(name, 5, dtype=torch.float32)
    got = _run(emulated, qp, idxbu, idxbx)
    want = fused_ipm_lanes_plain(qp, idxbu, idxbx, iters=ITERS)
    assert all(torch.isfinite(g).all() for g in got)
    assert float((got[1] - want[1]).abs().max()) <= 5e-3
    assert torch.equal(lane_status(*got, TOL) == 0,
                       lane_status(*want, TOL) == 0)


def _check(emulated, qp, idxbu, idxbx):
    got = _run(emulated, qp, idxbu, idxbx)
    want = fused_ipm_lanes_plain(qp, idxbu, idxbx, iters=ITERS)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-9)
    torch.testing.assert_close(got[2], want[2], rtol=1e-9, atol=0)
    assert torch.equal(lane_status(*got, TOL), lane_status(*want, TOL))


@pytest.mark.parametrize("name", OCPS[:3] + ("usv_guidance_ca",
                                              "usv_guidance4", "race_cars"))
def test_emulated_kernel_nan_lane(emulated, name):
    """A NaN in one lane's dx0: that lane gets status 2, and every other
    lane's outputs are bitwise what they were."""
    L, lane = 5, 3
    qp, idxbu, idxbx = _qp(name, L)
    ref = _run(emulated, qp, idxbu, idxbx)
    dx0 = qp.dx0.clone()
    dx0[0, lane] = float("nan")
    got = _run(emulated, qp._replace(dx0=dx0), idxbu, idxbx)
    status = lane_status(*got, TOL)
    assert int(status[lane]) == 2
    keep = torch.arange(L) != lane
    for g, r in zip(got, ref):
        assert torch.equal(g[..., keep], r[..., keep])
    assert torch.equal(status[keep], lane_status(*ref, TOL)[keep])


def test_emulated_entry_refuses_a_horizon_beyond_shared_memory(emulated):
    """A horizon whose per-lane state exceeds a block's shared memory is
    refused (-3, which kernels/ipm.py raises as a ValueError) before any
    launch; N=100 is far inside."""
    ptrs = (ctypes.c_void_p * 32)()
    one = (ctypes.c_int * 1)(0)
    assert emulated.nmpc_fused_ipm_lanes(
        1, 8, 1, 1, 0, 0, 8, 400, 1, ITERS, 0.995, 0.1, 1.0, one, one, ptrs,
        None) == -3
