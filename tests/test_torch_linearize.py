"""The port's plain fused linearization (K2's plain version) vs the JAX
package's lax linearization and its Pallas kernel in interpret mode; and
the device dispatch of `linearize_lanes`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.kernels.linearize_pallas import (
    linearize_lanes_pallas)
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu_torch.kernels import linearize
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.linearize_lanes import (
    linearize_lanes, linearize_lanes_plain)


def _lax_reference(spec, xs, ubar, params):
    """Dense jax.linearize of the RK4 map and of h (the pattern of
    tests/test_linearize_pallas.py), J (nx, nxu, N, L), C (nh, nx, N, L)."""
    m = spec.model
    nx, nu = m.nx, m.nu
    h_step = spec.dt / spec.integrator_steps

    def F(xu):
        x, u = xu[:nx], xu[nx:]
        for _ in range(spec.integrator_steps):
            k1 = m.f(x, u, params)
            k2 = m.f(x + 0.5 * h_step * k1, u, params)
            k3 = m.f(x + 0.5 * h_step * k2, u, params)
            k4 = m.f(x + h_step * k3, u, params)
            x = x + (h_step / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    xu = jnp.concatenate([xs, ubar], axis=0)
    xn, lin = jax.linearize(F, xu)
    basis = jnp.broadcast_to(jnp.eye(nx + nu)[:, :, None, None],
                             (nx + nu,) + xu.shape)
    J = jnp.transpose(jax.vmap(lin)(basis), (1, 0, 2, 3))
    hbar, linh = jax.linearize(lambda xv: m.h(xv, params), xs)
    basis_x = jnp.broadcast_to(jnp.eye(nx)[:, :, None, None],
                               (nx,) + xs.shape)
    C = jnp.transpose(jax.vmap(linh)(basis_x), (1, 0, 2, 3))
    return xn, J, hbar, C


def _random_traj(m, N, L, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(m.nx, N, L)) * 0.5
    ub = rng.normal(size=(m.nu, N, L)) * 0.2
    params = rng.uniform(2.0, 50.0, size=(m.np_, L))
    return xs, ub, params


def _port(spec, xs, ub, params, fn=linearize_lanes_plain):
    args = [torch.as_tensor(a) for a in (xs, ub, params)]
    return fn(*args, model=spec.model, dt=spec.dt,
              integrator_steps=spec.integrator_steps)


def _to_port_layout(xn, J, hbar, C):
    """JAX kernel layout -> the port's: J (N, nx, nxu, L), C (N, nh, nx, L)."""
    return (np.asarray(xn), np.transpose(np.asarray(J), (2, 0, 1, 3)),
            np.asarray(hbar), np.transpose(np.asarray(C), (2, 0, 1, 3)))


def test_plain_matches_jax_lax():
    spec, jspec = (builders.usv_guidance_ca1(Tf=1.0, N=12),
                   jbuilders.usv_guidance_ca1(Tf=1.0, N=12))
    xs, ub, params = _random_traj(spec.model, N=12, L=8, seed=11)
    got = _port(spec, xs, ub, params)
    want = _to_port_layout(*_lax_reference(
        jspec, jnp.asarray(xs), jnp.asarray(ub), jnp.asarray(params)))
    for name, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12,
                                   err_msg=name)


def test_skipped_columns_are_exact():
    """Columns outside f_dep are exact identity / zero, outside h_dep zero."""
    spec = builders.usv_guidance_ca1(Tf=1.0, N=5)
    m = spec.model
    xs, ub, params = _random_traj(m, N=5, L=3, seed=4)
    _, J, _, C = _port(spec, xs, ub, params)
    for k in range(m.nx + m.nu):
        if k in m.f_dep:
            continue
        col = J[:, :, k, :]
        want = torch.zeros_like(col)
        if k < m.nx:
            want[:, k, :] = 1.0
        assert torch.equal(col, want), k
    for k in range(m.nx):
        if k not in m.h_dep:
            assert torch.equal(C[:, :, k, :], torch.zeros_like(C[:, :, k, :]))


def test_plain_matches_jax_pallas_interpret():
    """The JAX kernel evaluates a polynomial atan2 (ops/kmath.py); the port
    the native one: agreement at the Pallas test file's tolerances."""
    spec, jspec = (builders.usv_guidance_ca1(Tf=1.0, N=12),
                   jbuilders.usv_guidance_ca1(Tf=1.0, N=12))
    m = jspec.model
    xs, ub, params = _random_traj(spec.model, N=12, L=8, seed=12)
    got = _port(spec, xs, ub, params)
    want = _to_port_layout(*linearize_lanes_pallas(
        jnp.asarray(xs), jnp.asarray(ub), jnp.asarray(params), f=m.f,
        h=m.h, dt=jspec.dt, integrator_steps=jspec.integrator_steps,
        nh=m.nh, interpret=True, f_dep=m.f_dep, h_dep=m.h_dep))
    for name, g, w in zip(("xn", "J", "hbar", "C"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_dispatch_takes_plain_version_for_cpu_tensors():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=4)
    xs, ub, params = _random_traj(spec.model, N=4, L=2, seed=5)
    before = linearize.launches
    got = _port(spec, xs, ub, params, fn=linearize_lanes)
    want = _port(spec, xs, ub, params)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert linearize.launches == before


def test_kernel_wrapper_refuses_cpu_tensors_and_unknown_models():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=4)
    xs, ub, params = _random_traj(spec.model, N=4, L=2, seed=6)
    with pytest.raises(ValueError, match="CUDA device"):
        _port(spec, xs, ub, params, fn=linearize.linearize_lanes_cuda)
    other = spec.model.__class__(**{**spec.model.__dict__,
                                    "name": "no_such_model"})
    with pytest.raises(NotImplementedError, match="no_such_model"):
        linearize.linearize_lanes_cuda(
            *(torch.as_tensor(a) for a in (xs, ub, params)), model=other,
            dt=spec.dt)
