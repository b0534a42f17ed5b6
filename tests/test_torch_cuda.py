"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip with the reason.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -rs -m cuda --noconftest
"""

import dataclasses
import gc
import weakref

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


# K1's instances with the CTA design (nu <= 2) and their main-path N
CTA_INSTANCES = [(8, 1, 100), (14, 2, 100), (8, 2, 100), (5, 2, 20),
                 (9, 1, 100), (10, 1, 100), (12, 1, 100), (11, 1, 100),
                 (4, 1, 100), (5, 1, 100), (6, 2, 50)]
# L = MOST: the most lanes the rule gives the CTA design (the SM count)
MOST = 0


def _k1(design, d):
    """K1 on `d` in `design`, through the wrapper where the rule picks it
    (asserting that it did), else through `lqr_solve_lanes_cuda_as`; one
    launch counted either way."""
    nx, nu, L = d.A.shape[1], d.B.shape[2], d.A.shape[3]
    rule = ("cta" if L <= riccati.cta_lanes(d.A.device, d.A.dtype, nx, nu)
            else "warp")
    before = (riccati.launches, dict(riccati.launches_by_design))
    got = (riccati.lqr_solve_lanes_cuda(*d) if design == rule
           else riccati.lqr_solve_lanes_cuda_as(design, *d))
    assert riccati.launches == before[0] + 1
    assert riccati.launches_by_design[design] == before[1][design] + 1
    return got


@pytest.mark.parametrize("design", ["warp", "cta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu,L,N", [
    (8, 1, 1, 30), (8, 1, 33, 30), (8, 1, 130, 30),
    (14, 2, 1, 30), (14, 2, 33, 30), (14, 2, 130, 100),
    (8, 2, 1, 20), (8, 2, 130, 100), (5, 2, 33, 20), (5, 2, 130, 2),
    (9, 1, 33, 100), (10, 1, 130, 100), (12, 1, 1, 100), (12, 1, 130, 100),
    (11, 1, 33, 100), (4, 1, 130, 100), (4, 1, 33, 2), (5, 1, 1, 100),
    (5, 1, 130, 100), (6, 2, 1, 50), (6, 2, 130, 50), (6, 2, 33, 2),
    *((nx, nu, L, N) for nx, nu, N in CTA_INSTANCES for L in (3, MOST))])
def test_riccati_kernel_matches_plain(card, nx, nu, L, N, dtype, design):
    """Both designs.  The warp design on ragged lane groups: L=1 (one lane
    of a 4-lane block), 3, 33 and 130 (a last block of 1, 3 and 2 lanes);
    L=130 in float64 also takes the 16-byte copies, the other widths the
    element copies.  The CTA design at L=1 (its fields contiguous: 16-,
    8- and 4-byte pieces), at 3, 33 and 130 (pieces L apart), and at MOST,
    the most lanes the rule gives it.  (8, 2) and (5, 2) also at N=20
    (usv_acados, usv_position_control) and N=2, shorter than the tile
    rings; the guidance family's instances at their N=100, (4, 1) also at
    N=2; the race car's (6, 2) at its N=50 and N=2."""
    if L == MOST:
        L = riccati.cta_lanes(card, dtype, nx, nu)
    d = _random_lqr(N, nx, nu, L, seed=L, dtype=dtype, device=card)
    got = _k1(design, d)
    want = lqr_solve_lanes_plain(d)
    torch.cuda.synchronize()
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("nx,nu", riccati.SUPPORTED)
def test_riccati_kernel_design_by_lanes(card, nx, nu):
    """The rule: the CTA design for nu <= 2 up to one CTA per SM, the warp
    design past it and for the wide instances, as `launches_by_design`
    counts the wrapper's launches."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        most = riccati.cta_lanes(card, dtype, nx, nu)
        assert most == (sms if nu <= 2 else 0)
        for L in sorted({1, 3, most, most + 1, 512} - {0}):
            d = _random_lqr(4, nx, nu, L, seed=L, dtype=dtype, device=card)
            before = dict(riccati.launches_by_design)
            riccati.lqr_solve_lanes_cuda(*d)
            want = "cta" if L <= most else "warp"
            assert {k: riccati.launches_by_design[k] - before[k]
                    for k in before} == {"warp": int(want == "warp"),
                                         "cta": int(want == "cta")}, (L,
                                                                      dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,nu,L,N", [
    (8, 4, 1, 25), (8, 4, 130, 25), (8, 5, 33, 20), (8, 10, 130, 10),
    (8, 10, 1, 2), (14, 4, 130, 50), (14, 4, 33, 2), (14, 8, 33, 25),
    (14, 8, 130, 25), (6, 4, 130, 25), (6, 4, 1, 2)])
def test_riccati_macro_instances_match_plain(card, nx, nu, L, N, dtype):
    """The macro stages of condensed QPs (nu > 2: Huu and its factor in
    the warp's shared scratch) at their main-path N/M and at N=2, shorter
    than the tile rings, on ragged lane groups."""
    d = _random_lqr(N, nx, nu, L, seed=L + nu, dtype=dtype, device=card)
    got = riccati.lqr_solve_lanes_cuda(*d)
    want = lqr_solve_lanes_plain(d)
    torch.cuda.synchronize()
    rtol, atol = TOLS[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("nx,nu,design", [
    (nx, nu, design) for nx, nu in riccati.SUPPORTED
    for design in ("warp", "cta") if design == "warp" or nu <= 2])
def test_riccati_kernel_nan_lane_leaves_the_others_bitwise(card, nx, nu,
                                                           design):
    """One lane's A set to NaN: that lane goes non-finite, and every other
    lane (its warp design block's neighbours included) is bitwise what it
    was, in each design."""
    L, lane = 130, 6
    d = _random_lqr(25, nx, nu, L, seed=3, dtype=torch.float32, device=card)
    ref = _k1(design, d)
    A = d.A.clone()
    A[..., lane] = float("nan")
    got = _k1(design, d._replace(A=A))
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


@pytest.mark.parametrize("option", ["condense5", "pscan"])
def test_captured_option_tick_equals_eager_tick(card, option):
    """The lane engine's options on the production schedule, float32:
    condensed by 5 (K1 at (8, 5)) and the parallel-scan Riccati (no K1);
    the captured tick and its replay equal the eager tick bitwise."""
    from mpc_collisionavoidance_tpu_torch.solver.batch import LaneRTISolver
    pe = production_engine()
    kw = dict(ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
              centering=pe.centering, mu0=pe.mu0,
              extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)
    kw.update(condense=5) if option == "condense5" else kw.update(
        riccati="pscan")
    spec, x0s, lanes = _flagship_lanes(6, 25, torch.float32, card)
    eager = LaneRTISolver(spec, device=card, dtype=torch.float32,
                          capture=False, **kw)
    solver = LaneRTISolver(spec, device=card, dtype=torch.float32, **kw)
    st = solver.init_state(x0s)
    before = riccati.launches
    _, want = eager.step_fn(st, *lanes)
    assert (riccati.launches > before) == (option == "condense5")
    _, got = solver.step_fn(st, *lanes)
    _assert_bitwise(got, want)
    (_, got), graphs = _no_sync(lambda: solver.step_fn(st, *lanes))
    assert graphs == 1
    _assert_bitwise(got, want)


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


def test_released_program_escalation_launches_are_counted(card):
    """The escalation steps of a program released before the counters are
    read are counted all the same (the command line drops its solver
    before a caller reads them): K1 = 2 fixed + the device's count."""
    spec, x0s, lanes = _flagship_lanes(6, 25, torch.float64, card)
    solver = STARVED.build(spec, device=card, dtype=torch.float64)
    st = solver.init_state(x0s)
    solver.step_fn(LaneState(*(t.clone() for t in st)), *lanes)  # captures
    before = _counts()
    solver.step_fn(st, *lanes)
    k = int(solver.last_esc_iters)
    (program,) = solver._graphs.programs.values()
    released = weakref.ref(program)
    del solver, st, program
    gc.collect()
    assert released() is None
    counts = tuple(a - b for a, b in zip(_counts(), before))
    assert k > 0 and counts == (2 + k, 1, 0)


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


# ---------------------------------------------------------------------------
# the per-instance engine's routes to K1 and K2

def _instance_lqr(N, nx, nu, batch, dtype, device, seed=0):
    from mpc_collisionavoidance_tpu_torch.ops.riccati import LQRData
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(batch + shape) * 0.3

    Qr = rng.standard_normal(batch + (N + 1, nx, nx)) * 0.2
    Rr = rng.standard_normal(batch + (N, nu, nu)) * 0.2
    fields = (0.9 * np.eye(nx) + 0.05 * rng.standard_normal(
                  batch + (N, nx, nx)),
              arr(N, nx, nu), arr(N, nx),
              Qr @ np.swapaxes(Qr, -1, -2) + 0.5 * np.eye(nx),
              arr(N, nu, nx) * 0.1,
              Rr @ np.swapaxes(Rr, -1, -2) + 0.5 * np.eye(nu),
              arr(N + 1, nx), arr(N, nu), arr(nx))
    return LQRData(*(torch.tensor(f, dtype=dtype, device=device)
                     for f in fields))


@pytest.mark.parametrize("nx,nu", [(8, 1), (14, 2), (6, 2)])
@pytest.mark.parametrize("batch", [(), (3,), (2, 5)])
def test_instance_lqr_route_matches_plain(card, nx, nu, batch):
    """`ops/riccati.py::lqr_solve` on the card (the batch flattened onto
    K1's lanes) against its plain stage loop on the card; one K1 launch."""
    from mpc_collisionavoidance_tpu_torch.ops.riccati import (
        lqr_solve, lqr_solve_plain)
    for dtype in (torch.float32, torch.float64):
        d = _instance_lqr(20, nx, nu, batch, dtype, card)
        n0 = riccati.launches
        got = lqr_solve(d, reg=0.1)
        assert riccati.launches == n0 + 1
        want = lqr_solve_plain(d, reg=0.1)
        rtol, atol = TOLS[dtype]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


def test_instance_lqr_without_a_k1_instance_raises(card):
    from mpc_collisionavoidance_tpu_torch.ops.riccati import lqr_solve
    with pytest.raises(ValueError, match="no instance"):
        lqr_solve(_instance_lqr(4, 3, 1, (2,), torch.float64, card))


@pytest.mark.parametrize("qp_backend", ["riccati", "dense"])
def test_instance_ticks_on_card_match_cpu(card, qp_backend):
    """Three float64 ticks of `RTISolver.step_fn` at B=4 on the card, the
    captured tick (K2 per tick, K1 per IPM iteration on the Riccati
    backend; the first call also runs the capture's eager warm-up)
    against the CPU plain path, atol 1e-10, identical status."""
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    sc = scenarios.guidance_ca1_default()
    spec = builders.usv_guidance_ca1(Tf=2.0, N=25)
    x0s = np.broadcast_to(sc.x0, (4, 8)).copy()
    x0s[:, 2] += np.linspace(-0.5, 0.5, 4)
    outs = []
    for device in (card, "cpu"):
        solver = RTISolver(spec, qp_backend=qp_backend, device=device,
                           dtype=torch.float64)
        st, x = solver.init_state(x0s), torch.tensor(x0s, device=device)
        n0 = (riccati.launches, linearize.launches)
        ticks = []
        for _ in range(3):
            st, out = solver.step_fn(st, x, sc.params, sc.lh)
            ticks.append(out)
            x = out.x1
        outs.append(ticks)
        if device == card:
            assert linearize.launches - n0[1] == 4
            assert riccati.launches - n0[0] == (
                4 * 18 if qp_backend == "riccati" else 0)
    for got, want in zip(*outs):
        for field in ("u0", "x1", "xtraj", "qp_gap"):
            torch.testing.assert_close(getattr(got, field).cpu(),
                                       getattr(want, field), rtol=0,
                                       atol=1e-10)
        assert torch.equal(got.status.cpu(), want.status)


# ---------------------------------------------------------------------------
# the per-instance engine's captured tick

INSTANCE_RUNS = {
    # label: (RTISolver keywords, K1 launches per replay)
    "riccati": ({}, 18),
    "mehrotra": ({"centering": "mehrotra"}, 36),
    "dense": ({"qp_backend": "dense"}, 0),
}


def _instance(card, dtype, batch=(4,), capture_=True, N=25, **kw):
    """The flagship (N=25) on the card and its warm start, x0 (ye spread),
    params and lh on the card."""
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    sc = scenarios.guidance_ca1_default()
    spec = builders.usv_guidance_ca1(Tf=N * 0.05, N=N)
    x0s = np.broadcast_to(sc.x0, batch + (8,)).copy()
    x0s[..., 2] += np.linspace(-0.5, 0.5, int(np.prod(batch))).reshape(
        batch)
    solver = RTISolver(spec, **kw, device=card, dtype=dtype,
                       capture=capture_)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=card)

    return solver, solver.init_state(x0s), t(x0s), t(sc.params), t(sc.lh)


def _assert_instance_bitwise(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _leaves(v)]


@pytest.mark.parametrize("batch", [(), (4,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("run", sorted(INSTANCE_RUNS))
def test_instance_captured_equals_eager(card, run, dtype, batch):
    """The per-instance tick captured (the capturing call, then a replay
    with no sync and one graph launch) equals the eager tick
    (`capture=False`) bitwise, state and output, on the Riccati (fixed
    and Mehrotra) and dense backends; prepare_fn + feedback_fn likewise.
    Each replay counts K2 once and K1 once per Riccati solve."""
    kw, k1 = INSTANCE_RUNS[run]
    eager, st, x, p, lh = _instance(card, dtype, batch, False, **kw)
    solver = _instance(card, dtype, batch, **kw)[0]
    want = eager.step_fn(st, x, p, lh)
    _assert_instance_bitwise(solver.step_fn(st, x, p, lh), want)
    before = _counts()
    got, graphs = _no_sync(lambda: solver.step_fn(st, x, p, lh))
    assert graphs == 1
    assert tuple(a - b for a, b in zip(_counts(), before)) == (k1, 1, 0)
    _assert_instance_bitwise(got, want)
    want = eager.feedback_fn(st, eager.prepare_fn(st, p, lh), x)
    solver.feedback_fn(st, solver.prepare_fn(st, p, lh), x)   # captures
    qp, n_prep = _no_sync(lambda: solver.prepare_fn(st, p, lh))
    got, n_feed = _no_sync(lambda: solver.feedback_fn(st, qp, x))
    assert (n_prep, n_feed) == (1, 1)
    _assert_instance_bitwise(got, want)
    programs = solver._graphs.programs
    assert sorted(k[0] for k in programs) == ["feedback", "prepare", "step"]
    assert all(p.conditional == 0 for p in programs.values())


def _shifted(st, shift):
    """`st` with every stage state shifted by `shift` (another vehicle)."""
    return type(st)(st.xbar + shift, st.ubar.clone())


def test_instance_two_states_in_turn_match_two_solvers(card):
    """Two states taking ticks in turn through one captured solver (one
    static state between them) give two eager solvers' results bitwise,
    on full ticks and on the RTI split."""
    solver, st, x, p, lh = _instance(card, torch.float32, ())
    eager = [_instance(card, torch.float32, (), False)[0] for _ in range(2)]
    sts = [[st, _shifted(st, 0.3)], [st, _shifted(st, 0.3)]]
    xs = [[x, x + 0.3], [x, x + 0.3]]
    logs = [[], []]
    for k in range(4):
        for i in range(2):
            for run, s in ((0, solver), (1, eager[i])):
                if k % 2:
                    qp = s.prepare_fn(sts[run][i], p, lh)
                    sts[run][i], out = s.feedback_fn(sts[run][i], qp,
                                                     xs[run][i])
                else:
                    sts[run][i], out = s.step_fn(sts[run][i], xs[run][i], p,
                                                 lh)
                xs[run][i] = out.x1
                logs[run] += _leaves(out)
    assert len(solver._graphs.states) == 1
    _assert_instance_bitwise(logs[0], logs[1])


def test_instance_outputs_are_the_callers(card):
    """What a captured entry returns is the caller's: it shares no
    storage with the solver's tensors or its programs', and the state and
    output kept from tick k are unchanged after tick k+1."""
    solver, st, x, p, lh = _instance(card, torch.float64)
    st1, out1 = solver.step_fn(st, x, p, lh)
    kept = [t.clone() for t in _leaves((st1, out1))]
    qp = solver.prepare_fn(st1, p, lh)
    st2, out2 = solver.feedback_fn(st1, qp, out1.x1)
    st3, out3 = solver.step_fn(st2, out2.x1, p, lh)
    assert all(torch.equal(a, b) for a, b in zip(_leaves((st1, out1)),
                                                 kept))
    graphs = solver._graphs
    held = list(capture._held(solver))
    for program in graphs.programs.values():
        held += _leaves(program.inputs) + _leaves(program.outputs)
    for state in graphs.states.values():
        held += _leaves(state)
    own = {t.untyped_storage().data_ptr() for t in held if t.numel()}
    returned = _leaves((st1, out1, qp, st2, out2, st3, out3))
    assert not any(t.untyped_storage().data_ptr() in own for t in returned
                   if t.numel())


def test_instance_capture_that_syncs_raises(card, monkeypatch):
    """A per-instance tick that reads the device on the host cannot be
    captured: the capture raises, no program is kept, nothing launches
    and nothing runs eagerly in its place."""
    solver, st, x, p, lh = _instance(card, torch.float32)
    real = solver._advance

    def syncing(state, sol):
        float(sol.gap.max())
        return real(state, sol)

    monkeypatch.setattr(solver, "_advance", syncing)
    n0 = capture.launches
    with pytest.raises(RuntimeError):
        solver.step_fn(st, x, p, lh)
    assert capture.launches == n0 and not solver._graphs.programs


@pytest.mark.parametrize("run", sorted(INSTANCE_RUNS))
def test_instance_program_counts_its_launches(card, run):
    """A per-instance program is one unconditional segment whose replay
    counts K1 `ipm_iters` times (twice that under Mehrotra; none on the
    dense backend) and K2 once, with no escalation steps to settle."""
    kw, k1 = INSTANCE_RUNS[run]
    solver, st, x, p, lh = _instance(card, torch.float32, **kw)
    solver.step_fn(st, x, p, lh)
    (program,) = solver._graphs.programs.values()
    assert program.fixed == (k1, 1, 0) and program.per_step == (0, 0, 0)
    assert program.conditional == 0 and program.nodes > 0


def test_vmap_server_on_card_serves(card, tmp_path):
    """`RTServer(engine="vmap")` on the card: a solo tick and a batched
    tick of two vehicles reply status 0 or 1 with finite numbers."""
    import asyncio
    import contextlib
    import socket
    import threading

    from mpc_collisionavoidance_tpu_torch.rt import protocol
    from mpc_collisionavoidance_tpu_torch.rt.server import RTServer
    server = RTServer(str(tmp_path / "v.sock"), N=20, Tf=1.0, ipm_iters=8,
                      max_batch=4, engine="vmap", batch_window_ms=100.0,
                      device=card)
    server.warmup()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    x0 = (0.7, 0.0, -4.0, -1.5708, -1.5708, 0.0, 0.0, 0.0)
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(60)
        for n_vehicles in (1, 2):
            with contextlib.ExitStack() as stack:
                socks = []
                for _ in range(n_vehicles):
                    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    s.settimeout(120)
                    s.connect(server.path)
                    socks.append(stack.enter_context(contextlib.closing(s)))
                for k, s in enumerate(socks):
                    s.sendall(protocol.pack_request(protocol.Request(
                        seq=k, x0=x0, p_obs=(100.0,) * 16,
                        r_obs=(0.0,) * 8)))
                for k, s in enumerate(socks):
                    buf = b""
                    while len(buf) < protocol.RESP_SIZE:
                        buf += s.recv(protocol.RESP_SIZE - len(buf))
                    resp = protocol.unpack_response(buf)
                    assert resp.seq == k and resp.status in (0, 1)
                    assert np.all(np.isfinite(resp.x1))
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()


@pytest.fixture
def lone_group():
    """A test that starts a one-rank process group in this process; the
    group is destroyed after it."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("schedule", ["production", "starved"])
def test_mesh_tick_equals_unmeshed_tick_bitwise(card, lone_group, schedule):
    """chip_smoke phase 20(a) at B=64: the flagship's tick (N=100,
    float32, captured) with its lanes over a one-rank NCCL mesh, whose
    escalation predicate is all-reduced in the captured graph (in the
    unconditional segments before the steps), equals the tick without a
    mesh bitwise, capturing call and replay, with the same escalation
    count; K1 >= 4 and K2 = 1 on the counted replay."""
    from mpc_collisionavoidance_tpu_torch.parallel import distributed
    config = {"production": production_engine(), "starved": STARVED}[schedule]
    group = distributed.global_scenario_mesh().get_group()
    spec, x0s, lanes = _flagship_lanes(64, 100, torch.float32, card)
    plain = config.build(spec, device=card, dtype=torch.float32)
    meshed = config.build(spec, device=card, dtype=torch.float32,
                          group=group)
    st = plain.init_state(x0s)
    for _ in range(2):
        _, want = plain.step_fn(st, *lanes)
        before = _counts()
        _, got = meshed.step_fn(st, *lanes)
        launched = tuple(a - b for a, b in zip(_counts(), before))
        _assert_bitwise(got, want)
        assert int(meshed.last_esc_iters) == int(plain.last_esc_iters)
    assert launched[0] >= 4 and launched[1:] == (1, 0), launched
    if schedule == "starved":
        assert 0 < int(meshed.last_esc_iters) < STARVED.extra_iters


def test_gloo_mesh_refuses_a_captured_tick(card, lone_group):
    """A gloo group on the card: gloo's collectives cannot be captured,
    so a captured lane engine on it raises ValueError; capture=False
    runs."""
    import torch.distributed as dist
    from mpc_collisionavoidance_tpu_torch.parallel import distributed
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    group = distributed.make_mesh(device=card).get_group()
    assert dist.get_backend(group) == "gloo"
    spec, x0s, lanes = _flagship_lanes(6, 25, torch.float32, card)
    with pytest.raises(ValueError, match="needs NCCL"):
        STARVED.build(spec, device=card, dtype=torch.float32, group=group)
    eager = STARVED.build(spec, device=card, dtype=torch.float32,
                          capture=False, group=group)
    _, out = eager.step_fn(eager.init_state(x0s), *lanes)
    assert torch.isfinite(out.u0).all() and int(eager.last_esc_iters) > 0
