"""The port's RK4 shooting integrators (`ops/integrators.py`) vs the JAX
package's, float64 on the CPU: the step, the multi-substep map and the
discrete sensitivities of each model family at 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.models import registry as jregistry
from mpc_collisionavoidance_tpu.models import variants as jvariants
from mpc_collisionavoidance_tpu.ops import integrators as jint
from mpc_collisionavoidance_tpu.utils import track as jtrack
from mpc_collisionavoidance_tpu_torch.models import registry, variants
from mpc_collisionavoidance_tpu_torch.ops import integrators
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.utils import track as trk

TOL = 1e-12


def _models(name):
    """(the port's model, JAX's); "race_cars_track" on the synthetic
    curved track."""
    if name == "race_cars_track":
        return (variants.race_cars(track=trk.make_synthetic_track()),
                jvariants.race_cars(kappa_fn=jtrack.make_kappa_fn(
                    jtrack.make_synthetic_track())))
    return registry.get(name), jregistry.get(name)


def _point(name, K, seed):
    """K states around the model's scenario start (x0 + 0.05 N(0, 1)),
    controls 0.1 N(0, 1) and the scenario's params."""
    sc = scenarios.DEFAULTS[name.replace("_track", "")][0]()
    rng = np.random.default_rng(seed)
    x = sc.x0 + 0.05 * rng.standard_normal((K, len(sc.x0)))
    nu = _models(name)[1].nu
    return x, 0.1 * rng.standard_normal((K, nu)), np.asarray(sc.params,
                                                            float)


# model -> its builder's shooting interval Tf/N
MODELS = {"usv_guidance_ca1": 0.05, "usv_pf_ca": 0.01, "usv_acados": 0.05,
          "usv_guidance": 0.01, "usv_guidance_ca": 0.05, "race_cars": 0.02,
          "race_cars_track": 0.02}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rk4_step_matches_jax(name):
    tm, jm = _models(name)
    x, u, p = _point(name, 6, seed=1)
    dt = MODELS[name]
    got = integrators.rk4_step(tm.f, torch.tensor(x), torch.tensor(u),
                               torch.tensor(p), dt)
    want = jax.vmap(lambda xi, ui: jint.rk4_step(jm.f, xi, ui,
                                                 jnp.asarray(p), dt))(
        jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name,steps", [("usv_guidance_ca1", 1),
                                        ("usv_pf_ca", 2),
                                        ("race_cars_track", 3)])
def test_sensitivities_match_jax(name, steps):
    """x_next and its Jacobians d/dx, d/du (jvp columns vs jax.jacfwd),
    per stage of a batch (rtol 1e-12 too: the hull's stiff sway-drag
    entries are large)."""
    tm, jm = _models(name)
    x, u, p = _point(name, 5, seed=2)
    dt = MODELS[name]
    G = integrators.make_discrete_dynamics_with_sens(tm.f, dt, steps)
    jG = jint.make_discrete_dynamics_with_sens(jm.f, dt, steps)
    got = G(torch.tensor(x), torch.tensor(u), torch.tensor(p))
    want = jax.jit(jax.vmap(jG, in_axes=(0, 0, None)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(p))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    F = integrators.make_discrete_dynamics(tm.f, dt, steps)
    np.testing.assert_array_equal(
        F(torch.tensor(x), torch.tensor(u), torch.tensor(p)).numpy(),
        got[0].numpy())


def test_rk4_is_exact_on_a_linear_system():
    """The step of xdot = A x + b u is exact to fourth order: it equals
    the truncated exponential series (the JAX suite's check)."""
    A = np.array([[0.0, 1.0], [-2.0, -0.3]])

    def f(x, u, p):                                  # state-first
        return torch.stack([x[1] + 0 * u[0], -2.0 * x[0] - 0.3 * x[1]
                            + u[0]])

    x = torch.tensor([[0.4, -0.2]], dtype=torch.float64)
    u = torch.tensor([[0.1]], dtype=torch.float64)
    h = 0.1
    got = integrators.rk4_step(f, x, u, torch.zeros(0), h)
    Ah = A * h
    series = np.eye(2) + Ah + Ah @ Ah / 2 + Ah @ Ah @ Ah / 6 \
        + Ah @ Ah @ Ah @ Ah / 24
    # the forced response of a constant input through the same series
    phi = (np.eye(2) + Ah / 2 + Ah @ Ah / 6 + Ah @ Ah @ Ah / 24) * h
    want = series @ x[0].numpy() + phi @ np.array([0.0, 0.1])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-15)
