"""The port's kinematic guidance family — `usv_guidance_ca`,
`usv_guidance`, `usv_guidance2`..`usv_guidance5` (model, builder,
scenario, linearization, production and fused ticks) — vs the JAX
package's, float64 on the CPU, at N=8 and B <= 8; and JAX's own float32
closed loops at the builders' N, which the card's gates stand on."""

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
from tests.torch_family import GUIDANCE, guidance_point

# the JAX package's scenario of each model (the port's: scenarios.DEFAULTS)
JAX_SCENARIOS = {"usv_guidance_ca": jscenarios.guidance_ca_default,
                 "usv_guidance": jscenarios.guidance_default,
                 "usv_guidance2": jscenarios.guidance2_default,
                 "usv_guidance3": jscenarios.guidance3_default,
                 "usv_guidance4": jscenarios.guidance4_default,
                 "usv_guidance5": jscenarios.guidance5_default}


def _rk4(f, x, u, p, h):
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * h * k1, u, p)
    k3 = f(x + 0.5 * h * k2, u, p)
    k4 = f(x + h * k3, u, p)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", GUIDANCE)
def test_f_and_rk4_match_jax(name, seed):
    """f and one RK4 step at the builder's step; outside a kernel JAX's
    atan2 (ops/kmath.py) is the exact one, as the port's."""
    jm, tm = jregistry.get(name), registry.get(name)
    x, u, p = guidance_point(name, N=6, L=5, seed=seed)
    xt, ut, pt = (torch.as_tensor(a) for a in (x, u, p))
    xj, uj, pj = (jnp.asarray(a) for a in (x, u, p))
    np.testing.assert_allclose(tm.f(xt, ut, pt).numpy(),
                               np.asarray(jm.f(xj, uj, pj)),
                               rtol=0, atol=1e-12)
    h = builders.build(name).dt
    np.testing.assert_allclose(_rk4(tm.f, xt, ut, pt, h).numpy(),
                               np.asarray(_rk4(jm.f, xj, uj, pj, h)),
                               rtol=0, atol=1e-12)
    if tm.h is not None:
        np.testing.assert_allclose(tm.h(xt, pt).numpy(),
                                   np.asarray(jm.h(xj, pj)), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("name", GUIDANCE)
def test_model_static_data_matches_jax(name):
    jm, tm = jregistry.get(name), registry.get(name)
    assert (tm.np_, tm.nh) == ((16, 8) if name == "usv_guidance_ca"
                               else (0, 0))
    for field in dataclasses.fields(tm):
        a, b = getattr(tm, field.name), getattr(jm, field.name)
        if callable(a):
            continue
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("kw", [{}, {"Tf": 0.4, "N": 8}])
@pytest.mark.parametrize("name", GUIDANCE)
def test_builder_arrays_equal_jax(name, kw):
    ts, js = builders.build(name, **kw), getattr(jbuilders, name)(**kw)
    assert (ts.N, ts.Tf, ts.dt, ts.stage_scale, ts.integrator_steps) == \
        (js.N, js.Tf, js.dt, js.stage_scale, js.integrator_steps)
    for field in ("Vx", "Vu", "W", "yref", "Vx_e", "W_e", "yref_e"):
        assert np.array_equal(getattr(ts.cost, field),
                              getattr(js.cost, field)), field
    assert ts.soft is None and js.soft is None
    assert np.array_equal(ts.hard_h_rows(), js.hard_h_rows())
    assert len(ts.hard_h_rows()) == (8 if name == "usv_guidance_ca" else 0)
    if not kw:
        assert (ts.N, ts.Tf) == (100, 5.0 if name == "usv_guidance_ca"
                                 else 1.0)
    if name in ("usv_guidance_ca", "usv_guidance2"):
        # no control weight: Huu comes only from the control box's barrier
        assert ts.cost.W[-1, -1] == 0.0


@pytest.mark.parametrize("name", GUIDANCE)
def test_scenario_arrays_equal_jax(name):
    factory, _ = scenarios.DEFAULTS[name]
    ts, js = factory(), JAX_SCENARIOS[name]()
    for field in ("x0", "params", "lh", "waypoints", "yref", "yref_e"):
        a, b = getattr(ts, field), getattr(js, field)
        assert (a is None and b is None) or np.array_equal(a, b), field
    assert (ts.name, ts.n_steps, ts.ak) == (js.name, js.n_steps, js.ak)


@pytest.mark.parametrize("name", GUIDANCE)
def test_linearization_matches_jax(name):
    """linearize_lanes_plain vs jax.linearize of the RK4 map and of h,
    densely, at the builder's step over 6 stages; hbar and C have 0 rows
    where the model has none."""
    Tf = 6 * builders.build(name).dt
    spec = builders.build(name, N=6, Tf=Tf)
    jspec = getattr(jbuilders, name)(N=6, Tf=Tf)
    m, nx = jspec.model, jspec.model.nx
    nxu = nx + m.nu
    x, u, p = guidance_point(name, N=6, L=5, seed=3)
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
    np.testing.assert_allclose(J.numpy(), Jj, rtol=0, atol=1e-12)
    if m.h is None:
        assert hbar.shape == (0, 6, 5) and C.shape == (6, 0, nx, 5)
        return
    hj, linh = jax.linearize(lambda xv: m.h(xv, jnp.asarray(p)),
                             jnp.asarray(x))
    basis_x = jnp.broadcast_to(jnp.eye(nx)[:, :, None, None],
                               (nx,) + x.shape)
    Cj = np.transpose(np.asarray(jax.vmap(linh)(basis_x)), (2, 1, 0, 3))
    np.testing.assert_allclose(hbar.numpy(), np.asarray(hj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(C.numpy(), Cj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", GUIDANCE)
def test_linearization_matches_jax_pallas_interpret(name):
    """JAX's Pallas K2 in interpret mode evaluates the crab angle with its
    polynomial atan2 (ops/kmath.py, ~3e-7 in float32); the port's forms
    with the native one: agreement at the Pallas test file's tolerances
    (tests/test_linearize_pallas.py), on 12 stages at the builder's
    step."""
    Tf = 12 * builders.build(name).dt
    spec = builders.build(name, N=12, Tf=Tf)
    m = getattr(jbuilders, name)(N=12, Tf=Tf).model
    x, u, p = guidance_point(name, N=12, L=8, seed=12)
    got = linearize_lanes_plain(
        *(torch.as_tensor(a) for a in (x, u, p)), model=spec.model,
        dt=spec.dt, integrator_steps=spec.integrator_steps)
    xn, J, hbar, C = linearize_lanes_pallas(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(p), f=m.f, h=m.h,
        dt=spec.dt, integrator_steps=spec.integrator_steps, nh=m.nh,
        interpret=True, f_dep=m.f_dep, h_dep=m.h_dep)
    # the JAX kernel's J (nx, nxu, N, L), C (nh, nx, N, L): the port's
    # layout is (N, rows, cols, L)
    want = (np.asarray(xn), np.transpose(np.asarray(J), (2, 0, 1, 3)),
            np.asarray(hbar), np.transpose(np.asarray(C), (2, 0, 1, 3)))
    for what, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5,
                                   err_msg=what)


def _lanes_of(name, B, seed, dtype=np.float64):
    """x0 (B, nx) from the default scenario, its coordinate perturbed by
    0.1 N(0, 1); the scenario's params (B, np), lh (B, nh) and yref,
    yref_e (None where the scenario has none: the builder's zero
    reference)."""
    factory, coord = scenarios.DEFAULTS[name]
    sc = factory()
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (B, sc.x0.size)).copy()
    x0s[:, coord] += 0.1 * rng.standard_normal(B)
    params = np.broadcast_to(sc.params, (B, sc.params.size))
    lh = np.broadcast_to(sc.lh, (B, sc.lh.size))
    return ([np.array(a, dtype) for a in (x0s, params, lh)],
            dict(yref=sc.yref, yref_e=sc.yref_e))


def _jax_lane(spec, schedule):
    if schedule == "production":
        pe = jconfig.production_engine("cpu")
        return JaxLane(spec, ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
                       centering=pe.centering, mu0=pe.mu0,
                       extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)
    return JaxLane(spec, ipm_iters=12)


@pytest.mark.parametrize("name", GUIDANCE)
def test_production_tick_matches_jax(name):
    """Two warm-started production ticks (x0 <- x1) at N=8, B=4, with the
    scenario's obstacle table, lh and references; the second starts from
    JAX's warm start carried across as numpy."""
    B, N = 4, 8
    (x0s, params, lh), ref = _lanes_of(name, B, seed=5)
    js = _jax_lane(getattr(jbuilders, name)(N=N), "production")
    ts = production_engine().build(builders.build(name, N=N), device="cpu",
                                   dtype=torch.float64)
    jst, tst = js.init_state(x0s, dtype=jnp.float64), ts.init_state(x0s)
    jx, jp, jl = (jax_lanes(jnp.asarray(a)) for a in (x0s, params, lh))
    tx, tp, tl = (to_lanes(torch.as_tensor(a)) for a in (x0s, params, lh))
    for _ in range(2):
        jst, out_j = js.step_fn(jst, jx, jp, jl, **ref)
        tst, out_t = ts.step_fn(tst, tx, tp, tl, **ref)
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


@pytest.mark.parametrize("name", GUIDANCE)
def test_fused_tick_matches_jax_fused_kernel_interpret(name):
    """One riccati="fused" tick (K3's plain version on the CPU) vs JAX's
    tick through its fused Pallas kernel in interpret mode, on each of the
    six structures: hard rows at nS = 0 with parameters
    (usv_guidance_ca), box rows only, and usv_guidance4's one control
    pair per stage with no state box."""
    B, N, iters = 5, 8, 5
    (x0s, params, lh), ref = _lanes_of(name, B, seed=7)
    js = JaxLane(getattr(jbuilders, name)(N=N), ipm_iters=iters,
                 riccati="fused_interpret")
    ts = SolverConfig(ipm_iters=iters, riccati="fused").build(
        builders.build(name, N=N), device="cpu", dtype=torch.float64)
    _, out_j = js.step_fn(js.init_state(x0s, dtype=jnp.float64),
                          *(jax_lanes(jnp.asarray(a))
                            for a in (x0s, params, lh)), **ref)
    _, out_t = ts.step_fn(ts.init_state(x0s),
                          *(to_lanes(torch.as_tensor(a))
                            for a in (x0s, params, lh)), **ref)
    for field in ("u0", "x1"):
        np.testing.assert_allclose(getattr(out_t, field).numpy(),
                                   np.asarray(getattr(out_j, field)),
                                   rtol=0, atol=1e-10, err_msg=field)
    np.testing.assert_allclose(out_t.gap.numpy(), np.asarray(out_j.gap),
                               rtol=1e-8)
    np.testing.assert_array_equal(out_t.status.numpy(),
                                  np.asarray(out_j.status))


@pytest.mark.parametrize("schedule", ["production", "fixed"])
@pytest.mark.parametrize("name", GUIDANCE)
def test_jax_float32_closed_loop_converges(name, schedule):
    """The reference behaviour the card's closed-loop gates stand on
    (chip_smoke.py phase 13): JAX's lane engine, float32 on the CPU, B=8,
    30 warm ticks from the default scenario (seed 0) at the builder's N,
    at the production schedule and at the fixed schedule of the fused
    backend (12 iterations, sigma 0.1, mu0 = 1).  On every model and both
    schedules every lane ends finite with its gap under 1e-5 (at B=64
    too, where usv_guidance_ca's fixed-schedule loop passes through a tick
    with no lane converged and recovers), so phase 13 gates all twelve
    loops."""
    B = 8
    (x0s, params, lh), ref = _lanes_of(name, B, seed=0, dtype=np.float32)
    js = _jax_lane(getattr(jbuilders, name)(), schedule)
    st = js.init_state(x0s, dtype=jnp.float32)
    x, p, lhl = (jax_lanes(jnp.asarray(a)) for a in (x0s, params, lh))
    refs = {k: None if v is None else jnp.asarray(v, jnp.float32)
            for k, v in ref.items()}
    step = jax.jit(lambda st, x: js.step_fn(st, x, p, lhl, **refs))
    for _ in range(30):
        st, out = step(st, x)
        x = out.x1
    assert np.isfinite(np.asarray(out.u0)).all()
    assert float((out.gap < 1e-5).mean()) > 0.9
