"""The port's flagship model, OCP builder and scenario vs the JAX
package's, float64 on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.models import variants as jvariants
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu_torch.models import registry, variants
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import scenarios


def _random_point(seed, N=6, L=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, N, L))
    u = rng.normal(size=(1, N, L)) * 0.3
    p = rng.uniform(-20.0, 20.0, size=(16, L))
    return x, u, p


def _rk4(f, x, u, p, h):
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * h * k1, u, p)
    k3 = f(x + 0.5 * h * k2, u, p)
    k4 = f(x + h * k3, u, p)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@pytest.mark.parametrize("seed", [0, 1])
def test_flagship_f_h_rk4_match_jax(seed):
    jm, tm = jvariants.usv_guidance_ca1(), variants.usv_guidance_ca1()
    x, u, p = _random_point(seed)
    xt, ut, pt = (torch.as_tensor(a) for a in (x, u, p))
    xj, uj, pj = (jnp.asarray(a) for a in (x, u, p))
    np.testing.assert_allclose(tm.f(xt, ut, pt).numpy(),
                               np.asarray(jm.f(xj, uj, pj)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.h(xt, pt).numpy(),
                               np.asarray(jm.h(xj, pj)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_rk4(tm.f, xt, ut, pt, 0.05).numpy(),
                               np.asarray(_rk4(jm.f, xj, uj, pj, 0.05)),
                               rtol=0, atol=1e-12)


def test_flagship_model_static_data_matches_jax():
    jm, tm = jvariants.usv_guidance_ca1(), registry.get("usv_guidance_ca1")
    for field in dataclasses.fields(tm):
        a, b = getattr(tm, field.name), getattr(jm, field.name)
        if callable(a):
            continue
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("kw", [{}, {"Tf": 2.0, "N": 25}])
def test_flagship_builder_arrays_equal_jax(kw):
    ts, js = builders.usv_guidance_ca1(**kw), jbuilders.usv_guidance_ca1(**kw)
    assert (ts.N, ts.Tf, ts.dt, ts.stage_scale, ts.integrator_steps) == \
        (js.N, js.Tf, js.dt, js.stage_scale, js.integrator_steps)
    for name in ("Vx", "Vu", "W", "yref", "Vx_e", "W_e", "yref_e"):
        assert np.array_equal(getattr(ts.cost, name), getattr(js.cost, name))
    for name in ("idxsh", "zl", "Zl", "zu", "Zu", "lsh", "ush"):
        assert np.array_equal(getattr(ts.soft, name), getattr(js.soft, name))
    assert np.array_equal(ts.hard_h_rows(), js.hard_h_rows())
    assert builders.build("usv_guidance_ca1", **kw).N == ts.N


def test_flagship_scenario_arrays_equal_jax():
    ts, js = scenarios.guidance_ca1_default(), jscenarios.guidance_ca1_default()
    for name in ("x0", "params", "lh", "waypoints"):
        assert np.array_equal(getattr(ts, name), getattr(js, name)), name
    assert (ts.name, ts.n_steps, ts.ak) == (js.name, js.n_steps, js.ak)
    assert scenarios.SENTINEL_POS == jscenarios.SENTINEL_POS
