"""The port's hydrodynamic models without obstacle rows — `usv_pf`,
`usv_low_level`, `usv_acados`, `usv_position_control` (model, builder,
scenario, linearization, production and fused ticks) — vs the JAX
package's, float64 on the CPU, at N=8 and B <= 8."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.models import registry as jregistry
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import (SolverConfig,
                                                     production_engine)
from mpc_collisionavoidance_tpu_torch.models import registry
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes_plain)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
from tests.torch_family import FAMILY, HYDRO, random_point

# the JAX package's scenario of each model (the port's: scenarios.DEFAULTS)
JAX_SCENARIOS = {"usv_pf": jscenarios.pf_default,
                 "usv_low_level": jscenarios.low_level_default,
                 "usv_acados": jscenarios.acados_speed_default,
                 "usv_position_control": jscenarios.position_control_default}


def _rk4(f, x, u, p, h):
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * h * k1, u, p)
    k3 = f(x + 0.5 * h * k2, u, p)
    k4 = f(x + h * k3, u, p)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", FAMILY)
def test_f_and_rk4_match_jax(name, seed):
    jm, tm = jregistry.get(name), registry.get(name)
    x, u, p = random_point(name, N=6, L=5, seed=seed)
    iu = HYDRO[name][0]
    assert (x[iu] > 1.25).any() and (x[iu] < 1.25).any()
    xt, ut, pt = (torch.as_tensor(a) for a in (x, u, p))
    xj, uj, pj = (jnp.asarray(a) for a in (x, u, p))
    np.testing.assert_allclose(tm.f(xt, ut, pt).numpy(),
                               np.asarray(jm.f(xj, uj, pj)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_rk4(tm.f, xt, ut, pt, 0.01).numpy(),
                               np.asarray(_rk4(jm.f, xj, uj, pj, 0.01)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", FAMILY)
def test_model_static_data_matches_jax(name):
    jm, tm = jregistry.get(name), registry.get(name)
    assert tm.np_ == tm.nh == 0 and tm.h is None
    for field in dataclasses.fields(tm):
        a, b = getattr(tm, field.name), getattr(jm, field.name)
        if callable(a):
            continue
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("kw", [{}, {"Tf": 0.4, "N": 8}])
@pytest.mark.parametrize("name", FAMILY)
def test_builder_arrays_equal_jax(name, kw):
    ts, js = builders.build(name, **kw), getattr(jbuilders, name)(**kw)
    assert (ts.N, ts.Tf, ts.dt, ts.stage_scale, ts.integrator_steps) == \
        (js.N, js.Tf, js.dt, js.stage_scale, js.integrator_steps)
    for field in ("Vx", "Vu", "W", "yref", "Vx_e", "W_e", "yref_e"):
        assert np.array_equal(getattr(ts.cost, field),
                              getattr(js.cost, field)), field
    assert ts.soft is None and js.soft is None
    assert len(ts.hard_h_rows()) == 0
    if not kw:
        assert ts.N == {"usv_acados": 20,
                        "usv_position_control": 20}.get(name, 100)
    if name == "usv_low_level":
        # the builder's non-zero default reference: cospsi = 1
        assert ts.cost.yref[2] == 1.0 and ts.cost.yref_e[2] == 1.0


@pytest.mark.parametrize("name", FAMILY)
def test_scenario_arrays_equal_jax(name):
    factory, _ = scenarios.DEFAULTS[name]
    ts, js = factory(), JAX_SCENARIOS[name]()
    for field in ("x0", "params", "lh", "waypoints", "yref", "yref_e"):
        assert np.array_equal(getattr(ts, field), getattr(js, field)), field
    assert (ts.name, ts.n_steps, ts.ak) == (js.name, js.n_steps, js.ak)


@pytest.mark.parametrize("name", FAMILY)
def test_linearization_matches_jax(name):
    """linearize_lanes_plain vs jax.linearize of the RK4 map, densely, at
    the kink lanes, at the builder's step over 6 stages; hbar and C have 0
    rows."""
    Tf = 6 * builders.build(name).dt
    spec = builders.build(name, N=6, Tf=Tf)
    jspec = getattr(jbuilders, name)(N=6, Tf=Tf)
    m, nx, nxu = jspec.model, jspec.model.nx, jspec.model.nx + 2
    x, u, p = random_point(name, N=6, L=5, seed=3, dt=spec.dt)
    xn, J, hbar, C = linearize_lanes_plain(
        *(torch.as_tensor(a) for a in (x, u, p)), model=spec.model,
        dt=spec.dt, integrator_steps=spec.integrator_steps)

    def F(xu):
        return _rk4(m.f, xu[:nx], xu[nx:], jnp.asarray(p), jspec.dt)

    xu = jnp.concatenate([jnp.asarray(x), jnp.asarray(u)])
    xnj, lin = jax.linearize(F, xu)
    basis = jnp.broadcast_to(jnp.eye(nxu)[:, :, None, None],
                             (nxu,) + xu.shape)
    Jj = np.transpose(np.asarray(jax.vmap(lin)(basis)), (2, 1, 0, 3))
    np.testing.assert_allclose(xn.numpy(), np.asarray(xnj), rtol=0,
                               atol=1e-12)
    # relative too: the sway-drag entries reach ~1e7
    np.testing.assert_allclose(J.numpy(), Jj, rtol=1e-12, atol=1e-12)
    # the v column of the r row at the kink lane is the one |v| decides
    _, iv, ir, _, _ = HYDRO[name]
    assert np.abs(Jj[:, ir, iv, 0]).min() > 1e-6
    assert hbar.shape == (0, 6, 5) and C.shape == (6, 0, nx, 5)


def _lanes_of(name, B, seed):
    """x0 (B, nx) from the default scenario, its coordinate perturbed by
    0.1 N(0, 1); the scenario's yref, yref_e."""
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (B, sc.x0.size)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(B)
    return x0s, sc.yref, sc.yref_e


@pytest.mark.parametrize("name", FAMILY)
def test_production_tick_matches_jax(name):
    """Two warm-started production ticks (x0 <- x1) at N=8, B=4, with the
    scenario's references and empty params / lh; the second starts from
    JAX's warm start carried across as numpy."""
    B, N = 4, 8
    x0s, yref, yref_e = _lanes_of(name, B, seed=5)
    pe = jconfig.production_engine("cpu")
    js = JaxLane(getattr(jbuilders, name)(N=N), ipm_iters=pe.ipm_iters,
                 ipm_tol=pe.ipm_tol, centering=pe.centering, mu0=pe.mu0,
                 extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)
    ts = production_engine().build(builders.build(name, N=N), device="cpu",
                                   dtype=torch.float64)
    jst, tst = js.init_state(x0s, dtype=jnp.float64), ts.init_state(x0s)
    empty = np.zeros((B, 0))
    jx, jp = (jax_lanes(jnp.asarray(a)) for a in (x0s, empty))
    tx, tp = (to_lanes(torch.as_tensor(a)) for a in (x0s, empty))
    ref = dict(yref=yref, yref_e=yref_e)
    for _ in range(2):
        jst, out_j = js.step_fn(jst, jx, jp, None, **ref)
        tst, out_t = ts.step_fn(tst, tx, tp, None, **ref)
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


@pytest.mark.parametrize("name", FAMILY)
def test_fused_tick_matches_jax_fused_kernel_interpret(name):
    """One riccati="fused" tick (K3's plain version on the CPU) vs JAX's
    tick through its fused Pallas kernel in interpret mode, on each of the
    three structures with no h rows (usv_position_control shares
    usv_low_level's)."""
    B, N, iters = 5, 8, 5
    x0s, yref, yref_e = _lanes_of(name, B, seed=7)
    js = JaxLane(getattr(jbuilders, name)(N=N), ipm_iters=iters,
                 riccati="fused_interpret")
    ts = SolverConfig(ipm_iters=iters, riccati="fused").build(
        builders.build(name, N=N), device="cpu", dtype=torch.float64)
    empty = np.zeros((B, 0))
    ref = dict(yref=yref, yref_e=yref_e)
    _, out_j = js.step_fn(js.init_state(x0s, dtype=jnp.float64),
                          *(jax_lanes(jnp.asarray(a)) for a in (x0s, empty)),
                          None, **ref)
    _, out_t = ts.step_fn(ts.init_state(x0s),
                          *(to_lanes(torch.as_tensor(a))
                            for a in (x0s, empty)), None, **ref)
    for field in ("u0", "x1"):
        np.testing.assert_allclose(getattr(out_t, field).numpy(),
                                   np.asarray(getattr(out_j, field)),
                                   rtol=0, atol=1e-10, err_msg=field)
    np.testing.assert_allclose(out_t.gap.numpy(), np.asarray(out_j.gap),
                               rtol=1e-8)
    np.testing.assert_array_equal(out_t.status.numpy(),
                                  np.asarray(out_j.status))


@pytest.mark.parametrize("schedule", ["production", "fixed"])
@pytest.mark.parametrize("name", FAMILY)
def test_jax_float32_closed_loop_converges(name, schedule):
    """The reference behaviour the card's closed-loop gates stand on
    (chip_smoke.py phase 12): JAX's lane engine, float32 on the CPU, B=8,
    30 warm ticks from the default scenario (seed 0) at the builder's N.
    At the production schedule every lane ends with its gap under 1e-5 on
    every model; at the fixed schedule of the fused backend (12
    iterations, sigma 0.1, mu0 = 1) on every model but
    usv_position_control, whose 1e5 weights need mu0="auto" (the last
    tick leaves 5 of its 8 lanes converged)."""
    B = 8
    x0s, yref, yref_e = _lanes_of(name, B, seed=0)
    spec = getattr(jbuilders, name)()
    if schedule == "production":
        pe = jconfig.production_engine("cpu")
        js = JaxLane(spec, ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
                     centering=pe.centering, mu0=pe.mu0,
                     extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)
    else:
        js = JaxLane(spec, ipm_iters=12)
    st = js.init_state(x0s, dtype=jnp.float32)
    x, p = (jax_lanes(jnp.asarray(a, jnp.float32))
            for a in (x0s, np.zeros((B, 0))))
    refs = (jnp.asarray(yref, jnp.float32), jnp.asarray(yref_e, jnp.float32))
    step = jax.jit(lambda st, x: js.step_fn(st, x, p, None, yref=refs[0],
                                            yref_e=refs[1]))
    for _ in range(30):
        st, out = step(st, x)
        x = out.x1
    converged = float((out.gap < 1e-5).mean())
    if schedule == "fixed" and name == "usv_position_control":
        assert converged == 5 / 8
    else:
        assert converged > 0.9


@pytest.mark.parametrize("schedule", ["production", "fixed"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_jax_usv_acados_loop_at_full_width(dtype, schedule):
    """Why chip_smoke.py admits solver-flagged failures (status 2) in
    usv_acados' closed loops: JAX's lane engine on the CPU at B=512 from
    the default scenario (seed 0), 30 warm ticks, at the production
    schedule and at the fused backend's fixed one.  In float32 a few lanes
    go non-finite near tick 20-22, with status 2, as the thrusts near their
    35 box (the fixed schedule's converged share dips towards 0 there and
    recovers); the others converge.  At the production schedule the
    batch's stall escalation, which iterates every lane until the slowest
    converges, is part of it: a subset of those lanes alone does not fail.
    In float64 no lane fails."""
    B = 512
    x0s, yref, yref_e = _lanes_of("usv_acados", B, seed=0)
    spec = jbuilders.usv_acados()
    if schedule == "production":
        pe = jconfig.production_engine("cpu")
        js = JaxLane(spec, ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
                     centering=pe.centering, mu0=pe.mu0,
                     extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)
    else:
        js = JaxLane(spec, ipm_iters=12)
    st = js.init_state(x0s, dtype=dtype)
    x, p = (jax_lanes(jnp.asarray(a, dtype)) for a in (x0s, np.zeros((B, 0))))
    refs = (jnp.asarray(yref, dtype), jnp.asarray(yref_e, dtype))
    step = jax.jit(lambda st, x: js.step_fn(st, x, p, None, yref=refs[0],
                                            yref_e=refs[1]))
    for _ in range(30):
        st, out = step(st, x)
        x = out.x1
    failed = np.asarray(out.status) == 2
    finite = np.isfinite(np.asarray(out.u0)).all(axis=0)
    assert np.array_equal(~finite, failed)
    assert float((np.asarray(out.gap) < 1e-5).mean()) > 0.9
    if dtype == jnp.float32:
        assert 1 <= int(failed.sum()) <= 25
    else:
        assert not failed.any()
