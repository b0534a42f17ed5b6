"""The port's race car — `utils/track.py`, the `race_cars` model on the
straight and the synthetic curved track, the `race_cars` and
`race_cars_dev` builders, soft state-box rows in the lane QP, and the
production and fused ticks — vs the JAX package's, float64 on the CPU at
the sizes of JAX's own race tests (N=10, Tf=0.4, B=4; the linearization
at N=12)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.kernels.linearize_pallas import (
    linearize_lanes_pallas)
from mpc_collisionavoidance_tpu.models import registry as jregistry
from mpc_collisionavoidance_tpu.models import variants as jvariants
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu.utils import track as jtrack
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import (SolverConfig,
                                                     production_engine)
from mpc_collisionavoidance_tpu_torch.models import registry, variants
from mpc_collisionavoidance_tpu_torch.models.base import TrackModel
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes_plain)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
from mpc_collisionavoidance_tpu_torch.utils import track as trk
from tests.torch_race import RACE_CASES, race_point, race_spec

TRACK = trk.make_synthetic_track()
JTRACK = jtrack.make_synthetic_track()


def _rk4(f, x, u, p, h):
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * h * k1, u, p)
    k3 = f(x + 0.5 * h * k2, u, p)
    k4 = f(x + h * k3, u, p)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _models(curved):
    """(the port's model, JAX's) on the curved or the straight track."""
    if curved:
        return (variants.race_cars(track=TRACK),
                jvariants.race_cars(kappa_fn=jtrack.make_kappa_fn(JTRACK)))
    return registry.get("race_cars"), jregistry.get("race_cars")


# ---------------------------------------------------------------------------
# the track

@pytest.mark.parametrize("kw", [{}, {"n_samples": 200, "radius": 0.6,
                                     "straight": 1.0, "chicane_amp": 0.2}])
def test_track_table_equals_jax(kw):
    ours, ref = trk.make_synthetic_track(**kw), jtrack.make_synthetic_track(
        **kw)
    for field in ("s0", "xref", "yref", "psiref", "kapparef"):
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field), err_msg=field)
    assert ours.length == ref.length


def _arcs():
    """s across the seam, negative, beyond one lap and on the samples."""
    L = TRACK.length
    ds = L / len(TRACK.s0)
    rng = np.random.default_rng(3)
    return np.concatenate([
        rng.uniform(-2.0, 3.0, 200) * L,
        np.array([0.0, L, -L, 2 * L, -1e-12, 1e-12, L - 1e-12]),
        np.arange(-3, 4) * ds, L + np.arange(-3, 4) * ds,
        TRACK.s0[::17], -L + 0.5 * ds * np.arange(9)])


@pytest.mark.parametrize("table,wrap", [("kapparef", 0.0), ("xref", 0.0),
                                        ("yref", 0.0),
                                        ("psiref", 2 * np.pi)])
def test_interpolant_matches_jax(table, wrap):
    s = _arcs()
    got = trk._interp_periodic(getattr(TRACK, table), torch.as_tensor(s),
                               TRACK.length, wrap).numpy()
    want = np.asarray(jtrack._interp_periodic(
        getattr(JTRACK, table), jnp.asarray(s), JTRACK.length, wrap))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_kappa_tangent_matches_jax():
    """d kappa / ds under torch.func.jvp and jax.jvp: the lap count and
    the sample index carry no tangent."""
    s = _arcs()
    _, got = torch.func.jvp(trk.make_kappa_fn(TRACK), (torch.as_tensor(s),),
                            (torch.ones(s.shape, dtype=torch.float64),))
    _, want = jax.jvp(jtrack.make_kappa_fn(JTRACK), (jnp.asarray(s),),
                      (jnp.ones(s.shape),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-11)


def test_transforms_match_jax():
    s = _arcs()
    rng = np.random.default_rng(4)
    n = rng.uniform(-0.1, 0.1, s.shape)
    alpha = rng.uniform(-0.5, 0.5, s.shape)
    got = trk.transform_proj2orig(TRACK, torch.as_tensor(s),
                                  torch.as_tensor(n), torch.as_tensor(alpha))
    want = jtrack.transform_proj2orig(JTRACK, jnp.asarray(s), jnp.asarray(n),
                                      jnp.asarray(alpha))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
    for i in range(0, s.size, 9):
        x, y, psi = (float(a[i]) for a in got[:3])
        g = trk.transform_orig2proj(TRACK, x, y, psi)
        w = jtrack.transform_orig2proj(JTRACK, jnp.float64(x),
                                       jnp.float64(y), jnp.float64(psi))
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_allclose(float(a), float(b), rtol=0,
                                       atol=1e-13)


# ---------------------------------------------------------------------------
# the model and the builders

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("curved", [False, True])
def test_f_and_rk4_match_jax(curved, seed):
    tm, jm = _models(curved)
    x, u, p = race_point(N=6, L=5, seed=seed)
    xt, ut, pt = (torch.as_tensor(a) for a in (x, u, p))
    xj, uj, pj = (jnp.asarray(a) for a in (x, u, p))
    np.testing.assert_allclose(tm.f(xt, ut, pt).numpy(),
                               np.asarray(jm.f(xj, uj, pj)), rtol=0,
                               atol=1e-12)
    h = builders.race_cars().dt / 3
    np.testing.assert_allclose(_rk4(tm.f, xt, ut, pt, h).numpy(),
                               np.asarray(_rk4(jm.f, xj, uj, pj, h)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.h(xt, pt).numpy(),
                               np.asarray(jm.h(xj, pj)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("curved", [False, True])
def test_model_static_data_matches_jax(curved):
    tm, jm = _models(curved)
    assert isinstance(tm, TrackModel) == curved
    for field in dataclasses.fields(tm):
        a = getattr(tm, field.name)
        if callable(a) or field.name in ("kapparef", "track_length"):
            continue
        b = getattr(jm, field.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name
    if curved:
        np.testing.assert_array_equal(tm.kapparef, JTRACK.kapparef)
        assert tm.track_length == JTRACK.length


@pytest.mark.parametrize("curved", [False, True])
@pytest.mark.parametrize("kw", [{}, {"Tf": 0.4, "N": 10}])
@pytest.mark.parametrize("name", ["race_cars", "race_cars_dev"])
def test_builder_arrays_equal_jax(name, kw, curved):
    ts = builders.build(name, track=TRACK if curved else None, **kw)
    js = jbuilders.build(name, track=JTRACK if curved else None, **kw)
    assert (ts.N, ts.Tf, ts.dt, ts.stage_scale, ts.integrator_steps) == \
        (js.N, js.Tf, js.dt, js.stage_scale, js.integrator_steps)
    assert ts.model.f_dep == js.model.f_dep
    for field in ("Vx", "Vu", "W", "yref", "Vx_e", "W_e", "yref_e"):
        assert np.array_equal(getattr(ts.cost, field),
                              getattr(js.cost, field)), field
    for part in ("soft", "soft_bx"):
        a, b = getattr(ts, part), getattr(js, part)
        assert (a is None) == (b is None) == (part == "soft_bx"
                                               and name == "race_cars")
        for f in () if a is None else dataclasses.fields(a):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name))
    assert np.array_equal(ts.hard_h_rows(), js.hard_h_rows())


def test_scenarios_follow_jax_race_recipe():
    """The JAX package has no race scenario: the port's follow its race
    recipe (tests/test_lane_engine.py:197-200, cli.py:185-186)."""
    jm = jregistry.get("race_cars")
    for name in ("race_cars", "race_cars_dev"):
        factory, coord = scenarios.DEFAULTS[name]
        sc = factory()
        x0 = jm.x0.copy()
        x0[3] = 0.5
        np.testing.assert_array_equal(sc.x0, x0)
        np.testing.assert_array_equal(sc.lh, jm.lh)
        assert sc.params.shape == (0,) and sc.yref is None
        for field in ("s0", "xref", "yref", "psiref", "kapparef"):
            np.testing.assert_array_equal(getattr(sc.track, field),
                                          getattr(JTRACK, field))
        assert coord == 1


# ---------------------------------------------------------------------------
# the linearization

@pytest.mark.parametrize("curved", [False, True])
def test_linearization_matches_jax_lax(curved):
    """linearize_lanes_plain vs JAX's lax linearization (jax.linearize of
    the RK4 map over 3 substeps and of h, dense), 12 stages."""
    spec = race_spec("race_cars", curved, N=12, Tf=12 * 0.02)
    jm = _models(curved)[1]
    nx, nxu = 6, 8
    x, u, p = race_point(N=12, L=6, seed=5)
    xn, J, hbar, C = linearize_lanes_plain(
        *(torch.as_tensor(a) for a in (x, u, p)), model=spec.model,
        dt=spec.dt, integrator_steps=spec.integrator_steps)

    def F(xu):
        xv = xu[:nx]
        for _ in range(3):
            xv = _rk4(jm.f, xv, xu[nx:], jnp.asarray(p), spec.dt / 3)
        return xv

    xu = jnp.concatenate([jnp.asarray(x), jnp.asarray(u)])
    xnj, lin = jax.linearize(F, xu)
    basis = jnp.broadcast_to(jnp.eye(nxu)[:, :, None, None],
                             (nxu,) + xu.shape)
    Jj = np.transpose(np.asarray(jax.vmap(lin)(basis)), (2, 1, 0, 3))
    np.testing.assert_allclose(xn.numpy(), np.asarray(xnj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(J.numpy(), Jj, rtol=0, atol=1e-11)
    hj, linh = jax.linearize(lambda xv: jm.h(xv, jnp.asarray(p)),
                             jnp.asarray(x))
    basis_x = jnp.broadcast_to(jnp.eye(nx)[:, :, None, None],
                               (nx,) + x.shape)
    Cj = np.transpose(np.asarray(jax.vmap(linh)(basis_x)), (2, 1, 0, 3))
    np.testing.assert_allclose(hbar.numpy(), np.asarray(hj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(C.numpy(), Cj, rtol=0, atol=1e-12)


def test_straight_linearization_matches_jax_pallas_interpret():
    """The straight form (JAX's Pallas K2 refuses the curved one: its
    table would be a closure constant) vs JAX's Pallas K2 in interpret
    mode, float32, at the Pallas test file's tolerances
    (tests/test_linearize_pallas.py:81-87), 12 stages, 3 substeps."""
    spec = builders.race_cars(N=12, Tf=12 * 0.02)
    m = jbuilders.race_cars(N=12, Tf=12 * 0.02).model
    x, u, p = (a.astype(np.float32) for a in race_point(N=12, L=8, seed=12))
    got = linearize_lanes_plain(
        *(torch.as_tensor(a) for a in (x, u, p)), model=spec.model,
        dt=spec.dt, integrator_steps=spec.integrator_steps)
    xn, J, hbar, C = linearize_lanes_pallas(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(p), f=m.f, h=m.h,
        dt=spec.dt, integrator_steps=spec.integrator_steps, nh=m.nh,
        interpret=True, f_dep=m.f_dep, h_dep=m.h_dep)
    want = (np.asarray(xn), np.transpose(np.asarray(J), (2, 0, 1, 3)),
            np.asarray(hbar), np.transpose(np.asarray(C), (2, 0, 1, 3)))
    for what, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# the lane QP and the ticks

def _lanes(B, seed, dtype=np.float64):
    """x0 (B, 6) of the race recipe: rolling at v = 0.5 + 0.1 N(0, 1) with
    a lateral offset of 0.05 N(0, 1) (tests/test_lane_engine.py:197-200);
    params (B, 0); lh (B, 5), the model's."""
    sc = scenarios.DEFAULTS["race_cars"][0]()
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (B, 6)).copy()
    x0s[:, 3] = 0.5 + 0.1 * rng.standard_normal(B)
    x0s[:, 1] = 0.05 * rng.standard_normal(B)
    return [np.array(a, dtype) for a in (
        x0s, np.zeros((B, 0)), np.broadcast_to(sc.lh, (B, 5)))]


@pytest.mark.parametrize("curved", [False, True])
def test_soft_box_qp_equals_jax(curved):
    """race_cars_dev's soft state-box rows in `_build_qp`: the selection
    rows appended to Cs (masked at stage 0), hofs = x xmask, the stage-0
    band slh = -1, suh = 1, and the static weights in the order [soft h
    rows | soft box rows], equal to JAX's; the hard box family is
    empty."""
    B, N = 4, 10
    x0s, params, lh = _lanes(B, seed=2)
    js = JaxLane(jbuilders.race_cars_dev(N=N, Tf=0.4,
                                         track=JTRACK if curved else None))
    ts = SolverConfig().build(race_spec("race_cars_dev", curved, N=N,
                                        Tf=0.4),
                              device="cpu", dtype=torch.float64)
    # a warm start away from x0: the box row's states differ per stage
    rng = np.random.default_rng(9)
    xbar = jax_lanes(jnp.asarray(x0s))[:, None, :] + 0.05 * jnp.asarray(
        rng.standard_normal((6, N + 1, B)))
    ubar = jnp.asarray(rng.standard_normal((2, N, B)))
    jst = js.init_state(x0s, dtype=jnp.float64)._replace(xbar=xbar,
                                                         ubar=ubar)
    tst = interop.lane_state_from_numpy(np.asarray(xbar), np.asarray(ubar),
                                        device="cpu", dtype=torch.float64)
    jqp = jax.jit(js._build_qp)(jst, jax_lanes(jnp.asarray(x0s)),
                       jax_lanes(jnp.asarray(params)),
                       jax_lanes(jnp.asarray(lh)))
    tqp = ts._build_qp(tst, to_lanes(torch.as_tensor(x0s)),
                       to_lanes(torch.as_tensor(params)),
                       to_lanes(torch.as_tensor(lh)))
    assert ts.idxbx == js.idxbx == () and ts.sbx_state_idx == (1,)
    assert tuple(tqp.Cs.shape) == (N, 6, 6, B)
    for field in ("Cs", "hofs", "slh", "suh", "zl", "Zl", "zu", "Zu", "lsh",
                  "ush", "Ch", "xb_lo"):
        g, w = getattr(tqp, field), np.asarray(getattr(jqp, field))
        assert tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12,
                                   err_msg=field)
    assert float(tqp.slh[0, 5].max()) == -1.0 == float(tqp.slh[0, 5].min())
    assert float(tqp.suh[0, 5].min()) == 1.0
    assert float(tqp.Zl[5, 0]) == ts.spec.dt


def _jax_lane(spec, schedule):
    if schedule == "production":
        pe = jconfig.production_engine("cpu")
        return JaxLane(spec, ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
                       centering=pe.centering, mu0=pe.mu0,
                       extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)
    return JaxLane(spec, ipm_iters=12, riccati="fused_interpret")


@pytest.mark.parametrize("schedule", ["production", "fused"])
@pytest.mark.parametrize("name,curved", RACE_CASES)
def test_ticks_match_jax(name, curved, schedule):
    """Three warm-started ticks (x0 <- x1) at N=10, Tf=0.4, B=4: the
    production tick against JAX's lax lane engine at the production
    schedule, the fused tick (K3's plain version) against JAX's tick
    through its fused Pallas kernel in interpret mode (with JAX's lax
    linearization, which runs the curved track); u0/x1 at 5e-6, status
    identical.  Each tick starts from JAX's warm start, carried across as
    numpy."""
    B, N = 4, 10
    x0s, params, lh = _lanes(B, seed=7)
    jspec = jbuilders.build(name, N=N, Tf=0.4,
                            track=JTRACK if curved else None)
    js = _jax_lane(jspec, schedule)
    config = (production_engine() if schedule == "production"
              else SolverConfig(riccati="fused"))
    ts = config.build(race_spec(name, curved, N=N, Tf=0.4), device="cpu",
                      dtype=torch.float64)
    jst, tst = js.init_state(x0s, dtype=jnp.float64), ts.init_state(x0s)
    jx, jp, jl = (jax_lanes(jnp.asarray(a)) for a in (x0s, params, lh))
    tx, tp, tl = (to_lanes(torch.as_tensor(a)) for a in (x0s, params, lh))
    jstep = jax.jit(js.step_fn)
    for _ in range(3):
        jst, out_j = jstep(jst, jx, jp, jl)
        tst, out_t = ts.step_fn(tst, tx, tp, tl)
        for field in ("u0", "x1"):
            np.testing.assert_allclose(getattr(out_t, field).numpy(),
                                       np.asarray(getattr(out_j, field)),
                                       rtol=0, atol=5e-6, err_msg=field)
        np.testing.assert_array_equal(out_t.status.numpy(),
                                      np.asarray(out_j.status))
        jx = out_j.x1
        tx = torch.as_tensor(np.array(out_j.x1))
        tst = interop.lane_state_from_numpy(
            np.asarray(jst.xbar), np.asarray(jst.ubar), device="cpu",
            dtype=torch.float64)


def _jax_float32_loop(name, curved, schedule, B):
    """JAX's lane engine in float32 on the CPU (64-bit types off, so that
    the curvature table, a float64 numpy array, enters the dynamics in
    float32 too), 30 warm ticks from the race scenario at the builder's
    N=50 (x0 with v = 0.5, n perturbed by 0.1 N(0, 1), seed 0) at the
    production schedule or the fused backend's fixed one (12 iterations,
    sigma 0.1, mu0 = 1); returns the last tick's output."""
    sc = scenarios.DEFAULTS[name][0]()
    rng = np.random.default_rng(0)
    x0s = np.broadcast_to(sc.x0, (B, 6)).copy()
    x0s[:, 1] += 0.1 * rng.standard_normal(B)
    x0s = x0s.astype(np.float32)
    with jax.enable_x64(False):
        spec = jbuilders.build(name, track=JTRACK if curved else None)
        js = (_jax_lane(spec, "production") if schedule == "production"
              else JaxLane(spec, ipm_iters=12))
        st = js.init_state(x0s, dtype=jnp.float32)
        x = jax_lanes(jnp.asarray(x0s))
        p = jnp.zeros((0, B), jnp.float32)
        lh = jax_lanes(jnp.asarray(np.broadcast_to(sc.lh, (B, 5)),
                                   jnp.float32))
        step = jax.jit(lambda st, x: js.step_fn(st, x, p, lh))
        for _ in range(30):
            st, out = step(st, x)
            x = out.x1
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("schedule", ["production", "fixed"])
@pytest.mark.parametrize("name,curved", [("race_cars", True),
                                         ("race_cars", False),
                                         ("race_cars_dev", True)])
def test_jax_float32_closed_loop(name, curved, schedule):
    """The reference behaviour that chip_smoke.py phase 14's gates stand
    on: JAX's lane engine (`_jax_float32_loop`) at B=8.  Every lane ends
    finite; every lane's gap is under 1e-5 (phase 14
    gates the loop), but on the straight track at the fixed schedule,
    where 5 of 8 lanes are: the reference's own shortfall, which phase 14
    prints and does not gate."""
    out = _jax_float32_loop(name, curved, schedule, B=8)
    assert np.isfinite(np.asarray(out.u0)).all()
    share = float((out.gap < 1e-5).mean())
    if not curved and schedule == "fixed":
        assert share == 0.625
    else:
        assert share > 0.9


@pytest.mark.parametrize("name,schedule", [("race_cars", "production"),
                                           ("race_cars_dev", "fixed")])
def test_jax_race_loop_at_full_width(name, schedule):
    """Why chip_smoke.py admits solver-flagged failures (status 2) in the
    curved track's closed loops: JAX's lane engine (`_jax_float32_loop`)
    at B=512 on the synthetic curved track.  A few lanes go non-finite,
    each with status 2, on the production schedule and on the fused
    backend's fixed one, for both OCPs; the others converge."""
    out = _jax_float32_loop(name, True, schedule, B=512)
    failed = np.asarray(out.status) == 2
    finite = np.isfinite(np.asarray(out.u0)).all(axis=0)
    assert np.all(failed[~finite])
    assert 1 <= int(failed.sum()) <= 25
    assert float((np.asarray(out.gap) < 1e-5).mean()) > 0.9
