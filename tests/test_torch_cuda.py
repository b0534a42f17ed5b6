"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip with the reason.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -rs -m cuda --noconftest
"""

import dataclasses

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
from mpc_collisionavoidance_tpu_torch.solver import capture
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneState, to_lanes
# by its own name (pytest puts tests/ on sys.path): on the card's machine
# an installed package named `tests` shadows this directory as a package
from torch_family import (FAMILY, GUIDANCE, guidance_point,  # noqa: E402
                          random_point)
from torch_race import RACE_CASES, race_point, race_spec  # noqa: E402

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


def _counts():
    """The kernels' launch counters, with the escalation steps of the
    captured ticks added (read from the device)."""
    capture.settle_launch_counts()
    return (riccati.launches, linearize.launches, ipm.launches)


def _counted_tick(solver, state, *args, **kw):
    """(output, launches of K1, K2, K3) of `solver.step_fn(state, ...)`.
    On the card the call before it captures the graph (with an eager
    warm-up), so the counted call replays it from the same state."""
    if solver.device.type == "cuda":
        solver.step_fn(LaneState(*(t.clone() for t in state)), *args, **kw)
    before = _counts()
    _, out = solver.step_fn(state, *args, **kw)
    return out, tuple(a - b for a, b in zip(_counts(), before))


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
@pytest.mark.parametrize("nx,nu,L,N", [
    (8, 1, 1, 30), (8, 1, 33, 30), (8, 1, 130, 30),
    (14, 2, 1, 30), (14, 2, 33, 30), (14, 2, 130, 100),
    (8, 2, 1, 20), (8, 2, 130, 100), (5, 2, 33, 20), (5, 2, 130, 2),
    (9, 1, 33, 100), (10, 1, 130, 100), (12, 1, 1, 100), (12, 1, 130, 100),
    (11, 1, 33, 100), (4, 1, 130, 100), (4, 1, 33, 2), (5, 1, 1, 100),
    (5, 1, 130, 100), (6, 2, 1, 50), (6, 2, 130, 50), (6, 2, 33, 2)])
def test_riccati_kernel_matches_plain(card, nx, nu, L, N, dtype):
    """Ragged lane groups: L=1 (one lane of a 4-lane block), 33 and 130
    (a last block of 1 and 2 lanes); L=130 in float64 also takes the
    16-byte copies, the other widths the element copies.  (8, 2) and
    (5, 2) also at N=20 (usv_acados, usv_position_control) and N=2,
    shorter than the tile rings; the guidance family's instances at
    their N=100, (4, 1) also at N=2; the race car's (6, 2) at its N=50
    and N=2."""
    d = _random_lqr(N, nx, nu, L, seed=L, dtype=dtype, device=card)
    before = riccati.launches
    got = riccati.lqr_solve_lanes_cuda(*d)
    want = lqr_solve_lanes_plain(d)
    torch.cuda.synchronize()
    assert riccati.launches == before + 1
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("nx,nu", riccati.SUPPORTED)
def test_riccati_kernel_nan_lane_leaves_the_others_bitwise(card, nx, nu):
    """One lane's A set to NaN: that lane goes non-finite, and every other
    lane (its block's neighbours included) is bitwise what it was."""
    L, lane = 130, 6
    d = _random_lqr(25, nx, nu, L, seed=3, dtype=torch.float32, device=card)
    ref = riccati.lqr_solve_lanes_cuda(*d)
    A = d.A.clone()
    A[..., lane] = float("nan")
    got = riccati.lqr_solve_lanes_cuda(*d._replace(A=A))
    torch.cuda.synchronize()
    keep = torch.arange(L, device=card) != lane
    for g, r in zip(got, ref):
        assert torch.equal(g[..., keep], r[..., keep])
    assert not torch.isfinite(got[0][..., lane]).all()


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
        out, (k1, k2, _) = _counted_tick(solver, solver.init_state(x0s),
                                         *lanes)
        outs[str(device)] = out
        if device == card:
            assert k1 >= 4
            assert k2 == 1
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


def _family_point(name, N, L, seed, dt):
    if name in GUIDANCE:
        return guidance_point(name, N, L, seed)
    return random_point(name, N, L, seed, dt=dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 45])
@pytest.mark.parametrize("name", FAMILY + GUIDANCE)
def test_linearize_family_kernel_matches_plain(card, name, L, dtype):
    """K2's hull family forms with no parameters and no rows (empty
    params, hbar, C), at the hull family's random points
    (tests/test_torch_hull_family.py: both sides of the drag switch, the
    kinks of |v| and |r|), and the guidance family's forms (usv_guidance_ca
    with its obstacle table and 8 rows) at forward surge."""
    # the builder's step (0.01 s, 0.05 s at N=20 or N=100 over 5 s) over
    # 12 stages
    spec = builders.build(name, N=12, Tf=12 * builders.build(name).dt)
    args = [torch.as_tensor(a, dtype=dtype, device=card)
            for a in _family_point(name, 12, L, seed=L, dt=spec.dt)]
    kw = dict(model=spec.model, dt=spec.dt,
              integrator_steps=spec.integrator_steps)
    before = linearize.launches
    got = linearize.linearize_lanes_cuda(*args, **kw)
    want = linearize_lanes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert linearize.launches == before + 1
    assert (got[2].numel() == got[3].numel() == 0) == (spec.model.nh == 0)
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=max(rtol, 1e-12), atol=atol)


@pytest.mark.parametrize("name", FAMILY + GUIDANCE)
def test_family_tick_on_card_matches_cpu(card, name):
    """The float64 production tick of each model of the hull family with
    no rows and of the guidance family on the card vs the CPU plain path,
    with the scenario's obstacle table, lh and references; the card runs
    K2 once and K1 at least 4 times."""
    spec = builders.build(name, N=20)
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    m = spec.model
    B = 6
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(B)
    outs = {}
    for device in ("cpu", card):
        solver = production_engine().build(spec, device=device,
                                           dtype=torch.float64)
        x, p, lh = (to_lanes(torch.tensor(np.asarray(a))).to(device)
                    for a in (x0s, np.broadcast_to(sc.params, (B, m.np_)),
                              np.broadcast_to(sc.lh, (B, m.nh))))
        out, counts = _counted_tick(solver, solver.init_state(x0s), x, p,
                                    lh, yref=sc.yref, yref_e=sc.yref_e)
        outs[str(device)] = out
        if device == card:
            assert counts[0] >= 4
            assert counts[1:] == (1, 0)
    cpu, gpu = outs["cpu"], outs[str(card)]
    torch.testing.assert_close(gpu.u0.cpu(), cpu.u0, rtol=0, atol=5e-6)
    torch.testing.assert_close(gpu.x1.cpu(), cpu.x1, rtol=0, atol=5e-6)
    assert torch.equal(gpu.status.cpu(), cpu.status)


def _spec(name, sc, **kw):
    """The OCP of the scenario `sc`: on its track, if it races on one."""
    return builders.build(name, **kw, **(
        {} if sc.track is None else {"track": sc.track}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 45])
@pytest.mark.parametrize("curved", [False, True])
def test_linearize_race_kernel_matches_plain(card, curved, L, dtype):
    """K2's race car forms, 3 RK4 substeps: the straight track's (no
    table) and the curved track's, which reads the curvature table from
    the card, at arc lengths across the seam, negative and in the second
    lap; the table is copied to the card once per device and dtype."""
    spec = race_spec("race_cars", curved, N=12, Tf=12 * 0.02)
    args = [torch.as_tensor(a, dtype=dtype, device=card)
            for a in race_point(12, L, seed=L)]
    kw = dict(model=spec.model, dt=spec.dt,
              integrator_steps=spec.integrator_steps)
    before = linearize.launches
    got = linearize.linearize_lanes_cuda(*args, **kw)
    got2 = linearize.linearize_lanes_cuda(*args, **kw)
    want = linearize_lanes_plain(*args, **kw)
    torch.cuda.synchronize()
    assert linearize.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=max(rtol, 1e-12), atol=atol)


@pytest.mark.parametrize("schedule", ["production", "fused"])
@pytest.mark.parametrize("name,curved", RACE_CASES)
def test_race_tick_on_card_matches_cpu(card, name, curved, schedule):
    """The float64 production and fused ticks of the race OCPs on the card
    vs the CPU plain path at N=50, B=6, from the race scenario (n
    perturbed); the card runs K2 once and K1 at least 4 times (production)
    or K3 once and no K1 (fused)."""
    spec = race_spec(name, curved)
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    B = 6
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, 6)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(B)
    config = (production_engine() if schedule == "production"
              else SolverConfig(riccati="fused"))
    outs = {}
    for device in ("cpu", card):
        solver = config.build(spec, device=device, dtype=torch.float64)
        x, p, lh = (to_lanes(torch.tensor(np.asarray(a))).to(device)
                    for a in (x0s, np.zeros((B, 0)),
                              np.broadcast_to(sc.lh, (B, 5))))
        out, counts = _counted_tick(solver, solver.init_state(x0s), x, p,
                                    lh)
        outs[str(device)] = out
        if device == card:
            k1 = counts[0]
            assert (k1 >= 4) if schedule == "production" else (k1 == 0)
            assert counts[1:] == (1, int(schedule == "fused"))
    cpu, gpu = outs["cpu"], outs[str(card)]
    torch.testing.assert_close(gpu.u0.cpu(), cpu.u0, rtol=0, atol=5e-6)
    torch.testing.assert_close(gpu.x1.cpu(), cpu.x1, rtol=0, atol=5e-6)
    assert torch.equal(gpu.status.cpu(), cpu.status)


def _fused_qp(name, L, dtype, device, N=12):
    """A LaneQP from the fused solver's own assembly at the OCP's default
    scenario, its coordinate perturbed."""
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    spec = _spec(name, sc, N=N)
    m = spec.model
    rng = np.random.default_rng(L)
    x0s = np.broadcast_to(sc.x0, (L, m.nx)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(L)
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
                                    ("usv_pf_ca", 37), ("usv_pf", 37),
                                    ("usv_low_level", 1),
                                    ("usv_position_control", 37),
                                    ("usv_acados", 37),
                                    ("usv_guidance_ca", 37),
                                    ("usv_guidance", 37),
                                    ("usv_guidance2", 1),
                                    ("usv_guidance3", 37),
                                    ("usv_guidance4", 37),
                                    ("usv_guidance5", 37),
                                    ("race_cars", 1), ("race_cars", 37),
                                    ("race_cars_dev", 37)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [5, 130])
@pytest.mark.parametrize("name", ["usv_guidance_ca1", "usv_pf_ca"])
def test_fused_ipm_kernel_matches_plain_at_more_widths(card, name, L,
                                                       dtype):
    """L=5 and 130 (one block per lane: no width is special to the
    kernel, but the float32 copies and the per-lane scratch are indexed
    by L)."""
    solver, qp = _fused_qp(name, L, dtype, card)
    args = (qp, solver.idxbu, solver.idxbx)
    got = ipm.fused_ipm_lanes_cuda(*args, iters=12)
    want = fused_ipm_lanes_plain(*args, iters=12)
    torch.cuda.synchronize()
    s_got, s_want = (lane_status(*o, 1e-7) for o in (got, want))
    if dtype == torch.float64:
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-9)
        torch.testing.assert_close(got[2], want[2], rtol=1e-9, atol=0)
        assert torch.equal(s_got, s_want)
    else:
        assert float((got[1] - want[1]).abs().max()) <= 5e-3
        assert abs(float((s_got == 0).float().mean())
                   - float((s_want == 0).float().mean())) <= 0.02


def test_k1_and_k3_instances_do_not_spill(card):
    """ptxas' report in the build's nvcc.log: 0 bytes spill stores and
    loads for every K1, K2 and K3 instance (chip_smoke.NO_SPILL)."""
    import chip_smoke
    chip_smoke.check_spills((_build.build().parent / "nvcc.log").read_text())


@pytest.mark.parametrize("name", ["usv_guidance_ca1", "usv_guidance_ca",
                                  "usv_guidance4", "race_cars",
                                  "race_cars_dev"])
def test_fused_ipm_kernel_nan_lane(card, name):
    solver, qp = _fused_qp(name, 37, torch.float64, card)
    dx0 = qp.dx0.clone()
    dx0[0, 5] = float("nan")
    bad = qp._replace(dx0=dx0)
    for fn in (ipm.fused_ipm_lanes_cuda, fused_ipm_lanes_plain):
        status = lane_status(*fn(bad, solver.idxbu, solver.idxbx), 1e-7)
        assert int(status[5]) == 2
        assert int((status == 2).sum()) == 1


@pytest.mark.parametrize("name", ["usv_guidance_ca1", "usv_pf_ca",
                                  "usv_pf", "usv_low_level", "usv_acados",
                                  "usv_position_control", "usv_guidance_ca",
                                  "usv_guidance4", "race_cars",
                                  "race_cars_dev"])
def test_fused_tick_launches_k3_once_and_never_k1(card, name):
    sc = scenarios.DEFAULTS[name][0]()
    spec = _spec(name, sc, N=12)
    m = spec.model
    B = 6
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    solver = SolverConfig(riccati="fused").build(spec, device=card,
                                                 dtype=torch.float32)
    lanes = [to_lanes(torch.tensor(np.asarray(a),
                                   dtype=torch.float32)).to(card)
             for a in (x0s, np.broadcast_to(sc.params, (B, m.np_)),
                       np.broadcast_to(sc.lh, (B, m.nh)))]
    out, counts = _counted_tick(solver, solver.init_state(x0s), *lanes)
    torch.cuda.synchronize()
    assert counts == (0, 1, 1)
    assert torch.isfinite(out.u0).all() and out.u0.shape == (m.nu, B)


def test_fused_ipm_kernel_refuses_other_structures(card):
    _, qp = _fused_qp("usv_guidance_ca1", 3, torch.float64, card)
    with pytest.raises(ValueError, match="no instance"):
        ipm.fused_ipm_lanes_cuda(qp, (), ())


def _flagship_lanes(B, N, dtype, device, seed=0):
    spec = builders.usv_guidance_ca1(Tf=5.0 * N / 100, N=N)
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (B, 8)).copy()
    x0s[:, 2] += 0.2 * rng.standard_normal(B)
    lanes = [to_lanes(torch.tensor(np.asarray(a), dtype=dtype)).to(device)
             for a in (x0s, np.broadcast_to(sc.params, (B, 16)),
                       np.broadcast_to(sc.lh, (B, 8)))]
    return spec, x0s, lanes


def test_mehrotra_on_card_matches_cpu_with_two_k1_per_iteration(card):
    """Mehrotra centering on the card (the affine probe and the corrector
    each one K1 launch) against the plain sweep on the CPU, float64."""
    spec, x0s, lanes = _flagship_lanes(6, 25, torch.float64, "cpu")
    solver = SolverConfig(ipm_iters=12).build(spec, device="cpu",
                                             dtype=torch.float64)
    qp = solver._build_qp(solver.init_state(x0s), *lanes)
    qp_card = qp._replace(**{k: v.to(card) for k, v in qp._asdict().items()
                             if isinstance(v, torch.Tensor)})
    from mpc_collisionavoidance_tpu_torch.ops.ipm_lanes import ipm_solve_lanes
    args = (solver.idxbu, solver.idxbx)
    want = ipm_solve_lanes(qp, *args, iters=12, centering="mehrotra")
    before = riccati.launches
    got = ipm_solve_lanes(qp_card, *args, iters=12, centering="mehrotra")
    torch.cuda.synchronize()
    assert riccati.launches - before == 24
    for g, w in zip((got.dx, got.du), (want.dx, want.du)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-9)
    assert torch.equal(got.status.cpu(), want.status)


def test_rti_split_on_card_equals_step(card):
    """prepare_fn (K2 once, no K1) + feedback_fn (K1, no K2) reproduce
    step_fn on the card, float64; the counted split replays the graphs
    that the split before it captured.  A captured tick writes its new
    state into the solver's state, so the state is cloned to be reused."""
    spec, x0s, (x, p, lh) = _flagship_lanes(6, 25, torch.float64, card)
    solver = production_engine().build(spec, device=card,
                                       dtype=torch.float64)
    st, _ = solver.step_fn(solver.init_state(x0s), x, p, lh)
    st = LaneState(*(t.clone() for t in st))
    x_meas = x + 0.05
    _, out_s = solver.step_fn(st, x_meas, p, lh)
    out_s = out_s._replace(u0=out_s.u0.clone(), x1=out_s.x1.clone())
    solver.feedback_fn(st, solver.prepare_fn(st, p, lh), x_meas)
    counts = _counts()
    qp = solver.prepare_fn(st, p, lh)
    assert _counts()[:2] == (counts[0], counts[1] + 1)
    _, out_f = solver.feedback_fn(st, qp, x_meas)
    torch.cuda.synchronize()
    after = _counts()
    assert after[1] == counts[1] + 1
    assert after[0] - counts[0] >= 4
    torch.testing.assert_close(out_f.u0, out_s.u0, rtol=0, atol=1e-12)
    torch.testing.assert_close(out_f.x1, out_s.x1, rtol=0, atol=1e-12)


def test_server_on_card_serves_through_the_kernels(card, tmp_path):
    """One v1 request to RTServer(device="cuda"): the served tick runs K2
    once and K1 per IPM iteration, and the reply is a finite solve."""
    import asyncio
    import socket
    import threading

    from mpc_collisionavoidance_tpu_torch.rt import protocol
    from mpc_collisionavoidance_tpu_torch.rt.server import RTServer
    sc = scenarios.guidance_ca1_default()
    server = RTServer(str(tmp_path / "rt.sock"), N=20, Tf=1.0, max_batch=4,
                      device=card)
    server.warmup()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)
    try:
        counts = _counts()
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(60)
            s.connect(server.path)
            s.sendall(protocol.pack_request(protocol.Request(
                seq=5, x0=tuple(map(float, sc.x0)),
                p_obs=tuple(map(float, sc.params)),
                r_obs=tuple(map(float, sc.lh)))))
            buf = b""
            while len(buf) < protocol.RESP_SIZE:
                buf += s.recv(protocol.RESP_SIZE - len(buf))
        resp = protocol.unpack_response(buf)
        assert resp.seq == 5 and resp.status in (0, 1)
        assert np.all(np.isfinite(np.r_[resp.u0, resp.x1]))
        after = _counts()
        assert after[1] - counts[1] == 1
        assert after[0] - counts[0] >= 4
        assert after[2] == counts[2]
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()


def _bits(t):
    """A float tensor's bits: a bitwise comparison that NaN passes."""
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.contiguous().view(as_int.get(t.dtype, t.dtype))


def _assert_bitwise(got, want):
    for field in ("u0", "x1", "gap", "status"):
        assert torch.equal(_bits(getattr(got, field)),
                           _bits(getattr(want, field))), field


def _no_sync(call):
    """`call()` with any sync raising; returns (its result, the graph
    launches it made)."""
    torch.cuda.synchronize()
    n0 = capture.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, capture.launches - n0


# the starved flagship of tests/test_escalation.py: escalation fires and
# stops before its 24 steps
STARVED = SolverConfig(ipm_iters=2, extra_iters=24)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("schedule", ["production", "fused", "starved",
                                      "mehrotra"])
def test_captured_tick_equals_eager_tick(card, schedule, dtype):
    """The captured tick (the capturing call and a replay from the same
    state, which makes no sync and one graph launch) equals the eager
    tick (`capture=False`) bitwise, with the same escalation count."""
    config = {"production": production_engine(),
              "fused": SolverConfig(riccati="fused"), "starved": STARVED,
              "mehrotra": dataclasses.replace(production_engine(),
                                              centering="mehrotra")}[schedule]
    spec, x0s, lanes = _flagship_lanes(6, 25, dtype, card)
    eager = config.build(spec, device=card, dtype=dtype, capture=False)
    solver = config.build(spec, device=card, dtype=dtype)
    st = solver.init_state(x0s)
    _, want = eager.step_fn(st, *lanes)
    k = int(eager.last_esc_iters)
    _, got = solver.step_fn(st, *lanes)
    _assert_bitwise(got, want)
    assert int(solver.last_esc_iters) == k
    (_, got), graphs = _no_sync(lambda: solver.step_fn(st, *lanes))
    assert graphs == 1
    _assert_bitwise(got, want)
    assert int(solver.last_esc_iters) == k
    if schedule == "starved":
        assert 0 < k < STARVED.extra_iters


def test_captured_escalation_launches_are_counted(card):
    """A replayed tick adds its fixed launches at once and K1's per
    escalation step once settled: K1 = 2 fixed + the device's count."""
    spec, x0s, lanes = _flagship_lanes(6, 25, torch.float64, card)
    solver = STARVED.build(spec, device=card, dtype=torch.float64)
    out, counts = _counted_tick(solver, solver.init_state(x0s), *lanes)
    k = int(solver.last_esc_iters)
    assert k > 0 and counts == (2 + k, 1, 0)
    (program,) = solver._graphs.programs.values()
    assert program.conditional == STARVED.extra_iters
    assert program.fixed[1:] == (1, 0) and program.per_step == (1, 0, 0)


def test_captured_rti_split_equals_eager(card):
    """prepare_fn and feedback_fn as captured graphs (one launch each, no
    sync in either) equal the eager split bitwise; the feedback graph
    reads the prepared QP where the preparation graph wrote it."""
    spec, x0s, (x, p, lh) = _flagship_lanes(6, 25, torch.float32, card)
    config = production_engine()
    eager = config.build(spec, device=card, dtype=torch.float32,
                         capture=False)
    solver = config.build(spec, device=card, dtype=torch.float32)
    st = solver.init_state(x0s)
    _, want = eager.feedback_fn(st, eager.prepare_fn(st, p, lh), x)
    solver.feedback_fn(st, solver.prepare_fn(st, p, lh), x)
    qp, n_prep = _no_sync(lambda: solver.prepare_fn(st, p, lh))
    (_, got), n_feed = _no_sync(lambda: solver.feedback_fn(st, qp, x))
    assert (n_prep, n_feed) == (1, 1)
    _assert_bitwise(got, want)
    feedback = solver._graphs.programs[next(
        k for k in solver._graphs.programs if k[0] == "feedback")]
    assert feedback.inputs[0].A is qp.A


def test_captured_tick_keeps_the_donated_state(card):
    """The captured step writes the new state into the solver's state
    tensors and returns them: a closed loop passes them back without a
    copy and matches the eager loop bitwise."""
    spec, x0s, (x, p, lh) = _flagship_lanes(6, 25, torch.float64, card)
    config = production_engine()
    eager = config.build(spec, device=card, dtype=torch.float64,
                         capture=False)
    solver = config.build(spec, device=card, dtype=torch.float64)
    st_e, st, x_e = eager.init_state(x0s), solver.init_state(x0s), x
    for tick in range(3):
        st_e, want = eager.step_fn(st_e, x_e, p, lh)
        st_new, got = solver.step_fn(st, x, p, lh)
        _assert_bitwise(got, want)
        if tick:
            assert st_new.xbar is st.xbar
        st, x, x_e = st_new, got.x1, want.x1


def test_capture_that_syncs_raises(card, monkeypatch):
    """A tick that reads the device on the host cannot be captured: the
    capture raises, with no eager fallback."""
    spec, x0s, lanes = _flagship_lanes(6, 25, torch.float32, card)
    solver = production_engine().build(spec, device=card,
                                       dtype=torch.float32)
    real = solver._advance

    def syncing(state, sol):
        float(sol.gap.max())
        return real(state, sol)

    monkeypatch.setattr(solver, "_advance", syncing)
    n0 = capture.launches
    with pytest.raises(RuntimeError):
        solver.step_fn(solver.init_state(x0s), *lanes)
    assert capture.launches == n0 and not solver._graphs.programs
