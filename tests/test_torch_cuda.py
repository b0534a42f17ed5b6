"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip with the reason.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -rs -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import (SolverConfig,
                                                     production_engine)
from mpc_collisionavoidance_tpu_torch.kernels import (_build, ipm, linearize,
                                                      riccati)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import (
    contiguous_qp, fused_ipm_lanes_plain, lane_status)
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes_plain)
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
    lqr_solve_lanes_plain)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes

pytestmark = pytest.mark.cuda

# float32: the JAX suite's kernel-vs-reference tolerances
# (tests/test_riccati_pallas.py, tests/test_linearize_pallas.py)
TOLS = {torch.float32: (2e-4, 2e-5), torch.float64: (0.0, 1e-10)}


@pytest.fixture
def card():
    """Skip unless a CUDA device and nvcc exist (decided here, not at
    import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the "
                    "card (python -m pytest tests/test_torch_cuda.py -m "
                    "cuda -rs --noconftest on the GPU machine)")
    try:
        _build.find_nvcc()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return torch.device("cuda")


def _random_lqr(N, nx, nu, L, seed, dtype, device):
    rng = np.random.default_rng(seed)
    Qr = rng.standard_normal((N + 1, nx, nx, L)) * 0.2
    Rr = rng.standard_normal((N, nu, nu, L)) * 0.2
    fields = (
        0.9 * np.eye(nx)[None, :, :, None]
        + 0.05 * rng.standard_normal((N, nx, nx, L)),
        rng.standard_normal((N, nx, nu, L)) * 0.3,
        rng.standard_normal((N, nx, L)) * 0.3,
        np.einsum("nikl,njkl->nijl", Qr, Qr) + 0.5 * np.eye(nx)[None, :, :,
                                                                None],
        rng.standard_normal((N, nu, nx, L)) * 0.03,
        np.einsum("nikl,njkl->nijl", Rr, Rr) + 0.5 * np.eye(nu)[None, :, :,
                                                                None],
        rng.standard_normal((N + 1, nx, L)) * 0.3,
        rng.standard_normal((N, nu, L)) * 0.3,
        rng.standard_normal((nx, L)) * 0.3)
    return interop.lane_lqr_from_numpy(*fields, device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu,L", [(8, 1, 1), (8, 1, 130), (14, 2, 33)])
def test_riccati_kernel_matches_plain(card, nx, nu, L, dtype):
    d = _random_lqr(30, nx, nu, L, seed=L, dtype=dtype, device=card)
    before = riccati.launches
    got = riccati.lqr_solve_lanes_cuda(*d)
    want = lqr_solve_lanes_plain(d)
    torch.cuda.synchronize()
    assert riccati.launches == before + 1
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 77])
def test_linearize_kernel_matches_plain(card, L, dtype):
    spec = builders.usv_guidance_ca1(Tf=1.0, N=12)
    m = spec.model
    rng = np.random.default_rng(L)
    args = [torch.as_tensor(a, dtype=dtype, device=card) for a in (
        rng.normal(size=(m.nx, 12, L)) * 0.5,
        rng.normal(size=(m.nu, 12, L)) * 0.2,
        rng.uniform(2.0, 50.0, size=(m.np_, L)))]
    kw = dict(model=m, dt=spec.dt, integrator_steps=spec.integrator_steps)
    before = linearize.launches
    got = linearize.linearize_lanes_cuda(*args, **kw)
    want = linearize_lanes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert linearize.launches == before + 1
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


def test_tick_on_card_matches_cpu_and_uses_both_kernels(card):
    spec = builders.usv_guidance_ca1(Tf=2.0, N=25)
    sc = scenarios.guidance_ca1_default()
    B = 6
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, 8)).copy()
    x0s[:, 2] += 0.1 * rng.standard_normal(B)
    outs = {}
    for device in ("cpu", card):
        solver = production_engine().build(spec, device=device,
                                           dtype=torch.float64)
        lanes = [to_lanes(torch.tensor(np.asarray(a))).to(device) for a in
                 (x0s, np.broadcast_to(sc.params, (B, 16)),
                  np.broadcast_to(sc.lh, (B, 8)))]
        k1, k2 = riccati.launches, linearize.launches
        _, out = solver.step_fn(solver.init_state(x0s), *lanes)
        outs[str(device)] = out
        if device == card:
            assert riccati.launches - k1 >= 4
            assert linearize.launches - k2 == 1
    cpu, gpu = outs["cpu"], outs[str(card)]
    torch.testing.assert_close(gpu.u0.cpu(), cpu.u0, rtol=0, atol=5e-6)
    torch.testing.assert_close(gpu.x1.cpu(), cpu.x1, rtol=0, atol=5e-6)
    assert torch.equal(gpu.status.cpu(), cpu.status)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 45])
def test_linearize_hull_kernel_matches_plain(card, L, dtype):
    """K2's hull model form (usv_pf_ca) at states across the 1.25 m/s drag
    switch, with v = 0 exactly on lane 0 (the kink of |v|)."""
    spec = builders.usv_pf_ca(N=12)
    m = spec.model
    rng = np.random.default_rng(L)
    xs = rng.normal(size=(m.nx, 12, L)) * 0.5
    xs[3] = rng.uniform(0.2, 2.0, size=(12, L))
    xs[4] = rng.normal(size=(12, L)) * 0.1
    xs[4, :, 0] = 0.0
    xs[12:14] = rng.uniform(-20.0, 30.0, size=(2, 12, L))
    args = [torch.as_tensor(a, dtype=dtype, device=card) for a in (
        xs, rng.normal(size=(m.nu, 12, L)) * 5.0,
        rng.uniform(-10.0, 20.0, size=(m.np_, L)))]
    kw = dict(model=m, dt=spec.dt, integrator_steps=spec.integrator_steps)
    before = linearize.launches
    got = linearize.linearize_lanes_cuda(*args, **kw)
    want = linearize_lanes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert linearize.launches == before + 1
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        # float64: relative too, the stiff sway-drag entries of J are large
        torch.testing.assert_close(g, w, rtol=max(rtol, 1e-12), atol=atol)


def _fused_qp(name, L, dtype, device, N=12):
    """A LaneQP from the fused solver's own assembly at the OCP's default
    scenario, ye perturbed."""
    spec = builders.build(name, N=N)
    sc = (scenarios.guidance_ca1_default() if name == "usv_guidance_ca1"
          else scenarios.pf_ca_default())
    m = spec.model
    rng = np.random.default_rng(L)
    x0s = np.broadcast_to(sc.x0, (L, m.nx)).copy()
    x0s[:, 2 if m.nx == 8 else 6] += 0.1 * rng.standard_normal(L)
    solver = SolverConfig(riccati="fused").build(spec, device=device,
                                                 dtype=dtype)
    lanes = [to_lanes(torch.tensor(np.asarray(a), dtype=dtype)).to(device)
             for a in (x0s, np.broadcast_to(sc.params, (L, m.np_)),
                       np.broadcast_to(sc.lh, (L, m.nh)))]
    qp = solver._build_qp(solver.init_state(x0s), *lanes)
    return solver, contiguous_qp(qp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,L", [("usv_guidance_ca1", 1),
                                    ("usv_guidance_ca1", 37),
                                    ("usv_pf_ca", 37)])
def test_fused_ipm_kernel_matches_plain(card, name, L, dtype):
    solver, qp = _fused_qp(name, L, dtype, card)
    args = (qp, solver.idxbu, solver.idxbx)
    before = ipm.launches
    got = ipm.fused_ipm_lanes_cuda(*args, iters=12)
    want = fused_ipm_lanes_plain(*args, iters=12)
    torch.cuda.synchronize()
    assert ipm.launches == before + 1
    s_got, s_want = (lane_status(*o, 1e-7) for o in (got, want))
    if dtype == torch.float64:
        # the kernel contracts to FMA: round-off, not bitwise
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-9)
        torch.testing.assert_close(got[2], want[2], rtol=1e-9, atol=0)
        assert torch.equal(s_got, s_want)
    else:
        # float32: the gap-floor ball on the controls
        assert float((got[1] - want[1]).abs().max()) <= 5e-3
        assert abs(float((s_got == 0).float().mean())
                   - float((s_want == 0).float().mean())) <= 0.02


def test_fused_ipm_kernel_nan_lane(card):
    solver, qp = _fused_qp("usv_guidance_ca1", 37, torch.float64, card)
    dx0 = qp.dx0.clone()
    dx0[0, 5] = float("nan")
    bad = qp._replace(dx0=dx0)
    for fn in (ipm.fused_ipm_lanes_cuda, fused_ipm_lanes_plain):
        status = lane_status(*fn(bad, solver.idxbu, solver.idxbx), 1e-7)
        assert int(status[5]) == 2
        assert int((status == 2).sum()) == 1


@pytest.mark.parametrize("name", ["usv_guidance_ca1", "usv_pf_ca"])
def test_fused_tick_launches_k3_once_and_never_k1(card, name):
    spec = builders.build(name, N=12)
    m = spec.model
    sc = (scenarios.guidance_ca1_default() if m.nx == 8
          else scenarios.pf_ca_default())
    B = 6
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    solver = SolverConfig(riccati="fused").build(spec, device=card,
                                                 dtype=torch.float32)
    lanes = [to_lanes(torch.tensor(np.asarray(a),
                                   dtype=torch.float32)).to(card)
             for a in (x0s, np.broadcast_to(sc.params, (B, m.np_)),
                       np.broadcast_to(sc.lh, (B, m.nh)))]
    counts = (riccati.launches, linearize.launches, ipm.launches)
    _, out = solver.step_fn(solver.init_state(x0s), *lanes)
    torch.cuda.synchronize()
    assert (riccati.launches - counts[0], linearize.launches - counts[1],
            ipm.launches - counts[2]) == (0, 1, 1)
    assert torch.isfinite(out.u0).all() and out.u0.shape == (m.nu, B)


def test_fused_ipm_kernel_refuses_other_structures(card):
    _, qp = _fused_qp("usv_guidance_ca1", 3, torch.float64, card)
    with pytest.raises(ValueError, match="no instance"):
        ipm.fused_ipm_lanes_cuda(qp, (), ())
