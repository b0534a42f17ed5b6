"""The port's plain Riccati sweep (K1's plain version) vs the JAX package's
lax sweep and its Pallas kernel in interpret mode, float64 on the CPU; and
the device dispatch of `lqr_solve_lanes`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.kernels.riccati_pallas import (
    lqr_solve_lanes_pallas)
from mpc_collisionavoidance_tpu.ops import riccati_lanes as jricc
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.kernels import riccati
from mpc_collisionavoidance_tpu_torch.ops.riccati_lanes import (
    lqr_solve_lanes, lqr_solve_lanes_plain)


def random_lqr(N, nx, nu, L, seed=0):
    """Random SPD LQR as numpy arrays (pattern of
    tests/test_riccati_pallas.py): SPD cost blocks, mildly contractive
    dynamics."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape) * 0.3

    Qr = rng.standard_normal((N + 1, nx, nx, L)) * 0.2
    Q = (np.einsum("nikl,njkl->nijl", Qr, Qr)
         + 0.5 * np.eye(nx)[None, :, :, None])
    Rr = rng.standard_normal((N, nu, nu, L)) * 0.2
    R = (np.einsum("nikl,njkl->nijl", Rr, Rr)
         + 0.5 * np.eye(nu)[None, :, :, None])
    A = (0.9 * np.eye(nx)[None, :, :, None]
         + 0.05 * rng.standard_normal((N, nx, nx, L)))
    return (A, arr(N, nx, nu, L), arr(N, nx, L), Q, arr(N, nu, nx, L) * 0.1,
            R, arr(N + 1, nx, L), arr(N, nu, L), arr(nx, L))


def _both(fields):
    d_t = interop.lane_lqr_from_numpy(*fields, device="cpu",
                                      dtype=torch.float64)
    d_j = jricc.LaneLQR(*(jnp.asarray(a) for a in fields))
    return d_t, d_j


@pytest.mark.parametrize("nx,nu", [(8, 1), (14, 2)])
def test_plain_matches_jax_lax(nx, nu):
    d_t, d_j = _both(random_lqr(N=12, nx=nx, nu=nu, L=8, seed=nx))
    dx, du = lqr_solve_lanes_plain(d_t)
    dx_r, du_r = jricc.lqr_solve_lanes(d_j)
    assert dx.shape == dx_r.shape and du.shape == du_r.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_r), rtol=1e-10)
    np.testing.assert_allclose(du.numpy(), np.asarray(du_r), rtol=1e-10)


@pytest.mark.parametrize("L", [128, 130])
@pytest.mark.parametrize("nx,nu", [(8, 1), (14, 2)])
def test_plain_matches_jax_pallas_interpret(nx, nu, L):
    """The plain sweep (the card's yardstick for K1) against JAX's Pallas
    kernel in interpret mode, at both K1 instances; L=130 makes Pallas
    pad to two 128-lane blocks."""
    d_t, d_j = _both(random_lqr(N=12, nx=nx, nu=nu, L=L, seed=5))
    dx, du = lqr_solve_lanes_plain(d_t)
    dx_r, du_r = lqr_solve_lanes_pallas(d_j, interpret=True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_r), rtol=1e-9)
    np.testing.assert_allclose(du.numpy(), np.asarray(du_r), rtol=1e-9)


def test_dispatch_takes_plain_sweep_for_cpu_tensors():
    d_t, _ = _both(random_lqr(N=6, nx=8, nu=1, L=3, seed=2))
    before = riccati.launches
    dx, du = lqr_solve_lanes(d_t)
    dx_p, du_p = lqr_solve_lanes_plain(d_t)
    assert torch.equal(dx, dx_p) and torch.equal(du, du_p)
    assert riccati.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back to the plain sweep."""
    d_t, _ = _both(random_lqr(N=4, nx=8, nu=1, L=2, seed=3))
    before = riccati.launches
    with pytest.raises(ValueError, match="CUDA device"):
        riccati.lqr_solve_lanes_cuda(*d_t)
    assert riccati.launches == before
