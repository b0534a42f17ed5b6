"""The per-instance Riccati solve `ops/riccati.py::lqr_solve` vs the JAX
package's `ops/riccati.py::lqr_solve` (under `jax.vmap` for a batch),
float64 on the CPU at atol 1e-10: the plain stage loop and the lane route
that a CUDA device takes (here on the lane sweep's plain version: the same
permutes that feed K1 on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ops import riccati as jricc
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.ops import riccati

TOL = 1e-10


def random_lqr(N, nx, nu, batch, seed):
    """Random SPD LQR as numpy arrays in the per-instance layout with
    leading `batch` axes (the pattern of tests/test_riccati_pallas.py)."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(batch + shape) * 0.3

    Qr = rng.standard_normal(batch + (N + 1, nx, nx)) * 0.2
    Q = Qr @ np.swapaxes(Qr, -1, -2) + 0.5 * np.eye(nx)
    Rr = rng.standard_normal(batch + (N, nu, nu)) * 0.2
    R = Rr @ np.swapaxes(Rr, -1, -2) + 0.5 * np.eye(nu)
    A = 0.9 * np.eye(nx) + 0.05 * rng.standard_normal(batch + (N, nx, nx))
    return (A, arr(N, nx, nu), arr(N, nx), Q, arr(N, nu, nx) * 0.1, R,
            arr(N + 1, nx), arr(N, nu), arr(nx))


def _jax(fields, reg=0.0):
    d = jricc.LQRData(*(jnp.asarray(a) for a in fields))
    solve = lambda d: jricc.lqr_solve(d, reg)          # noqa: E731
    for _ in range(fields[-1].ndim - 1):
        solve = jax.vmap(solve)
    dx, du = solve(d)
    return np.asarray(dx), np.asarray(du)


def _port(fields):
    return interop.lqr_data_from_numpy(*fields, device="cpu",
                                       dtype=torch.float64)


def _close(got, want):
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)


SHAPES = [(8, 1), (14, 2), (6, 2)]


@pytest.mark.parametrize("nx,nu", SHAPES)
@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_lqr_solve_matches_jax(nx, nu, batch):
    fields = random_lqr(12, nx, nu, batch, seed=nx + len(batch))
    _close(riccati.lqr_solve(_port(fields)), _jax(fields))


@pytest.mark.parametrize("nx,nu", SHAPES)
def test_lane_route_matches_jax(nx, nu):
    """The CUDA device's route (batch flattened onto the lane axis, the
    lane sweep, permuted back), run here on the lane sweep's plain
    version."""
    fields = random_lqr(12, nx, nu, (2, 3), seed=20 + nx)
    _close(riccati._lqr_solve_lanes(_port(fields), 0.0), _jax(fields))
    _close(riccati._lqr_solve_lanes(_port(fields), 0.3), _jax(fields, 0.3))


def test_regularization_matches_jax():
    fields = random_lqr(10, 8, 1, (3,), seed=5)
    _close(riccati.lqr_solve(_port(fields), reg=0.25), _jax(fields, 0.25))


def test_nan_instance_stays_its_own():
    """A NaN in one instance's A makes that instance NaN (JAX: the same),
    and leaves every other instance's solution bitwise as without it."""
    fields = list(random_lqr(10, 14, 2, (5,), seed=6))
    ref = riccati.lqr_solve(_port(fields))
    fields[0] = fields[0].copy()
    fields[0][2, 3] = np.nan
    got = riccati.lqr_solve(_port(fields))
    want = _jax(fields)
    for g, r, w in zip(got, ref, want):
        assert torch.isnan(g[2]).any() and np.isnan(w[2]).any()
        keep = [0, 1, 3, 4]
        assert torch.equal(g[keep], r[keep])
        np.testing.assert_allclose(g[keep].numpy(), w[keep], rtol=0,
                                   atol=TOL)


def test_indefinite_control_hessian_gives_nan_not_an_error():
    """`torch.linalg.cholesky` raises on a matrix that is not positive
    definite; the solve returns NaN for that instance only, as JAX's
    Cholesky does (the IPM's step rejection relies on it)."""
    fields = list(random_lqr(6, 8, 1, (3,), seed=7))
    fields[5] = fields[5].copy()
    fields[5][1] = -50.0 * np.eye(1)                   # R < 0 at instance 1
    got = riccati.lqr_solve(_port(fields))
    want = _jax(fields)
    for g, w in zip(got, want):
        assert np.array_equal(torch.isnan(g).numpy(), np.isnan(w))
        assert torch.isnan(g[1]).any() and not torch.isnan(g[[0, 2]]).any()
        np.testing.assert_allclose(g[[0, 2]].numpy(), w[[0, 2]], rtol=0,
                                   atol=TOL)


def test_device_picks_the_path():
    """CPU tensors take the plain stage loop; a tensor on another device
    takes the lane route (K1), which refuses an (nx, nu) it has no
    instance for and never runs on the CPU instead."""
    fields = random_lqr(6, 8, 1, (2,), seed=8)
    d = _port(fields)
    assert all(torch.equal(a, b) for a, b in zip(
        riccati.lqr_solve(d), riccati.lqr_solve_plain(d)))
    meta = riccati.LQRData(*(t.to("meta") for t in _port(
        random_lqr(4, 3, 1, (2,), seed=9))))
    with pytest.raises(ValueError):
        riccati.lqr_solve(meta)
