"""The port's 14-state hull `usv_pf_ca` (model, builder, scenario, its
linearization and its production tick) vs the JAX package's, float64 on
the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.models import variants as jvariants
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import production_engine
from mpc_collisionavoidance_tpu_torch.models import registry, variants
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes_plain)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes

NX, NU, NP, NH = 14, 2, 8, 4


def _random_point(seed, N=6, L=5):
    """Hull states around the operating point; surge speeds on both sides
    of the 1.25 m/s drag switch; lane 0 has v = 0 exactly with r != 0 (the
    kink of |v|), lane 1 has v = r = 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NX, N, L)) * 0.5
    x[3] = rng.uniform(0.2, 2.0, size=(N, L))            # u
    x[4, :, 0] = 0.0
    x[5, :, 0] = rng.uniform(0.2, 0.6, size=N) * np.sign(rng.normal(size=N))
    x[4:6, :, 1] = 0.0
    x[12:14] = rng.uniform(-20.0, 30.0, size=(2, N, L))   # thrusts
    u = rng.normal(size=(NU, N, L)) * 5.0
    p = rng.uniform(-10.0, 20.0, size=(NP, L))
    return x, u, p


def _rk4(f, x, u, p, h):
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * h * k1, u, p)
    k3 = f(x + 0.5 * h * k2, u, p)
    k4 = f(x + h * k3, u, p)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@pytest.mark.parametrize("seed", [0, 1])
def test_hull_f_h_rk4_match_jax(seed):
    jm, tm = jvariants.usv_pf_ca(), variants.usv_pf_ca()
    x, u, p = _random_point(seed)
    assert (x[3] > 1.25).any() and (x[3] < 1.25).any()
    xt, ut, pt = (torch.as_tensor(a) for a in (x, u, p))
    xj, uj, pj = (jnp.asarray(a) for a in (x, u, p))
    np.testing.assert_allclose(tm.f(xt, ut, pt).numpy(),
                               np.asarray(jm.f(xj, uj, pj)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.h(xt, pt).numpy(),
                               np.asarray(jm.h(xj, pj)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_rk4(tm.f, xt, ut, pt, 0.01).numpy(),
                               np.asarray(_rk4(jm.f, xj, uj, pj, 0.01)),
                               rtol=0, atol=1e-12)


def test_hull_jacobian_at_the_abs_kink_matches_jax():
    """J of the RK4 step where v = 0 and r != 0: JAX's |v| has derivative
    +1 at 0, the port's model must too (torch.abs would give 0 and change
    the d(rdot)/dv column through the - NRV |v| r term)."""
    spec, jspec = builders.usv_pf_ca(N=6), jbuilders.usv_pf_ca(N=6)
    m = jspec.model
    x, u, p = _random_point(3)
    _, J, hbar, C = linearize_lanes_plain(
        *(torch.as_tensor(a) for a in (x, u, p)), model=spec.model,
        dt=spec.dt, integrator_steps=spec.integrator_steps)

    def F(xu):
        return _rk4(m.f, xu[:NX], xu[NX:], jnp.asarray(p), jspec.dt)

    xu = jnp.concatenate([jnp.asarray(x), jnp.asarray(u)])
    _, lin = jax.linearize(F, xu)
    basis = jnp.broadcast_to(jnp.eye(NX + NU)[:, :, None, None],
                             (NX + NU,) + xu.shape)
    Jj = np.transpose(np.asarray(jax.vmap(lin)(basis)), (2, 1, 0, 3))
    # relative too: the sway-drag entries reach ~1e7
    np.testing.assert_allclose(J.numpy(), Jj, rtol=1e-12, atol=1e-12)
    # the v column of the r row at the kink lane is the one abs decides
    assert np.abs(Jj[:, 5, 4, 0]).min() > 1e-6
    hj = np.asarray(m.h(jnp.asarray(x), jnp.asarray(p)))
    np.testing.assert_allclose(hbar.numpy(), hj, rtol=0, atol=1e-12)
    assert C.shape == (6, NH, NX, 5)


def test_hull_model_static_data_matches_jax():
    jm, tm = jvariants.usv_pf_ca(), registry.get("usv_pf_ca")
    for field in dataclasses.fields(tm):
        a, b = getattr(tm, field.name), getattr(jm, field.name)
        if callable(a):
            continue
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("kw", [{}, {"Tf": 0.4, "N": 8}])
def test_hull_builder_arrays_equal_jax(kw):
    ts, js = builders.build("usv_pf_ca", **kw), jbuilders.usv_pf_ca(**kw)
    assert (ts.N, ts.Tf, ts.dt, ts.stage_scale, ts.integrator_steps) == \
        (js.N, js.Tf, js.dt, js.stage_scale, js.integrator_steps)
    for field in ("Vx", "Vu", "W", "yref", "Vx_e", "W_e", "yref_e"):
        assert np.array_equal(getattr(ts.cost, field),
                              getattr(js.cost, field)), field
    assert ts.soft is None and js.soft is None
    assert np.array_equal(ts.hard_h_rows(), js.hard_h_rows())


def test_hull_scenario_arrays_equal_jax():
    ts, js = scenarios.pf_ca_default(), jscenarios.pf_ca_default()
    for name in ("x0", "params", "lh", "waypoints", "yref", "yref_e"):
        assert np.array_equal(getattr(ts, name), getattr(js, name)), name
    assert (ts.name, ts.n_steps, ts.ak) == (js.name, js.n_steps, js.ak)


def test_hull_production_tick_matches_jax():
    """Two warm-started production ticks (x0 <- x1) at N=8, B=4; the
    second starts from JAX's warm start carried across as numpy."""
    B, N = 4, 8
    sc = jscenarios.pf_ca_default()
    rng = np.random.default_rng(5)
    x0s = np.broadcast_to(sc.x0, (B, NX)).copy()
    x0s[:, 6] += 0.1 * rng.standard_normal(B)
    params = np.broadcast_to(sc.params, (B, NP)).copy()
    lhs = np.broadcast_to(sc.lh, (B, NH)).copy()
    pe = jconfig.production_engine("cpu")
    js = JaxLane(jbuilders.usv_pf_ca(N=N), ipm_iters=pe.ipm_iters,
                 ipm_tol=pe.ipm_tol, centering=pe.centering, mu0=pe.mu0,
                 extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)
    ts = production_engine().build(builders.usv_pf_ca(N=N), device="cpu",
                                   dtype=torch.float64)
    jst = js.init_state(x0s, dtype=jnp.float64)
    tst = ts.init_state(x0s)
    jx, jp, jlh = (jax_lanes(jnp.asarray(a)) for a in (x0s, params, lhs))
    tx, tp, tlh = (to_lanes(torch.as_tensor(a)) for a in (x0s, params, lhs))
    for _ in range(2):
        jst, out_j = js.step_fn(jst, jx, jp, jlh)
        tst, out_t = ts.step_fn(tst, tx, tp, tlh)
        for name in ("u0", "x1"):
            np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                       np.asarray(getattr(out_j, name)),
                                       rtol=0, atol=5e-6, err_msg=name)
        np.testing.assert_array_equal(out_t.status.numpy(),
                                      np.asarray(out_j.status))
        jx = out_j.x1
        tx = torch.as_tensor(np.array(out_j.x1))
        tst = interop.lane_state_from_numpy(
            np.asarray(jst.xbar), np.asarray(jst.ubar), device="cpu",
            dtype=torch.float64)
