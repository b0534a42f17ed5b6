"""The port's full condensing (`ops/condense.py`) and dense QP engine
(`ops/dense_qp.py`, the qpOASES role) vs the JAX package's, float64 on the
CPU: the condensing map exact to 1e-10 and equal to JAX's, the dense
solve against JAX's at 1e-8 with identical status, and the dense engine
against the port's Riccati engine at 5e-6 (tests/test_dense_qp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ops import condense as jcond
from mpc_collisionavoidance_tpu.ops import dense_qp as jdense
from mpc_collisionavoidance_tpu_torch.ops import condense, dense_qp, ipm
from tests.test_ipm import make_qp
from tests.test_torch_ipm_instance import jax_qp, port_qp


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


@pytest.mark.parametrize("batch", [None, 3])
def test_condense_exactness(batch):
    """dx = M w + m satisfies the dynamics for any w, the condensed rows
    equal the stage rows, the objectives differ by a constant, and every
    DenseQP field equals JAX's."""
    rng = np.random.default_rng(10)
    qps = [make_qp(rng, N=6, nx=3, nu=2) for _ in range(batch or 1)]
    jqp = qps[0] if batch is None else jax.tree.map(
        lambda *a: jnp.stack(a), *qps)
    qp = port_qp(jqp)
    d = condense.condense(qp)
    N, nx, nu = qp.B.shape[-3:]
    shape = () if batch is None else (batch,)

    w = torch.tensor(rng.standard_normal(shape + (N * nu,)))
    dx, du = condense.expand(d, w, N, nu)
    res = (_mv(qp.A, dx[..., :-1, :]) + _mv(qp.B, du) + qp.c
           - dx[..., 1:, :])
    assert float(res.abs().max()) < 1e-12
    assert float((dx[..., 0, :] - qp.dx0).abs().max()) < 1e-12

    def stage_obj(dx, du):
        val = 0.5 * torch.einsum("...kx,...kxy,...ky->...", dx, qp.Q, dx)
        val = val + torch.einsum("...kx,...kx->...", qp.qx, dx)
        val = val + torch.einsum("...ku,...kux,...kx->...", du, qp.S,
                                 dx[..., :-1, :])
        val = val + 0.5 * torch.einsum("...ku,...kuv,...kv->...", du, qp.R,
                                       du)
        return val + torch.einsum("...ku,...ku->...", qp.qu, du)

    def cond_obj(w):
        return 0.5 * (w * _mv(d.H, w)).sum(-1) + (d.g * w).sum(-1)

    w2 = torch.tensor(rng.standard_normal(shape + (N * nu,)))
    dx2, du2 = condense.expand(d, w2, N, nu)
    np.testing.assert_allclose(
        (cond_obj(w) - cond_obj(w2)).numpy(),
        (stage_obj(dx, du) - stage_obj(dx2, du2)).numpy(), rtol=1e-10,
        atol=1e-10)
    g_stage = (_mv(qp.Gx, dx[..., :-1, :]) + _mv(qp.Gu, du) - qp.gl)
    np.testing.assert_allclose((_mv(d.Ghat, w) + d.dg).numpy(),
                               g_stage.reshape(shape + (-1,)).numpy(),
                               rtol=0, atol=1e-10)
    s_stage = qp.hofs + _mv(qp.Cx, dx[..., :-1, :])
    np.testing.assert_allclose((_mv(d.Chat, w) + d.dc).numpy(),
                               s_stage.reshape(shape + (-1,)).numpy(),
                               rtol=0, atol=1e-10)

    fn = jcond.condense if batch is None else jax.vmap(jcond.condense)
    want = fn(jqp)
    for field, g, wj in zip(want._fields, d, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), rtol=0,
                                   atol=1e-10, err_msg=field)


@pytest.mark.parametrize("case", ["random", "random_active", "flagship",
                                  "hull", "batch"])
def test_dense_qp_solve_matches_jax(case):
    """The port's dense engine against JAX's on the same QP: the JAX
    suite's random QPs (one with active hard rows) and QPs of the flagship
    and the hull from JAX's build_qp; a batch against `jax.vmap`."""
    rng = np.random.default_rng(11)
    if case == "random":
        jqp = make_qp(rng)
    elif case == "random_active":
        jqp = make_qp(rng, seed_scale=2.0)
        jqp = jqp._replace(gl=jnp.asarray(-0.05 - 0.05 * rng.random(
            jqp.gl.shape)))
    elif case == "flagship":
        jqp = jax_qp("usv_guidance_ca1", 12)
    elif case == "hull":
        jqp = jax_qp("usv_pf_ca", 8)
    else:
        jqp = jax_qp("usv_guidance_ca1", 8, batch=3, seed=2)
    fn = lambda q: jdense.dense_qp_solve(q, iters=30)   # noqa: E731
    want = jax.jit(jax.vmap(fn) if case == "batch" else fn)(jqp)
    got = dense_qp.dense_qp_solve(port_qp(jqp), iters=30)
    for field in ("dx", "du", "sl", "su", "gap", "eq_res"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-8,
                                   err_msg=field)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))


@pytest.mark.parametrize("case", ["random", "flagship"])
def test_dense_matches_riccati_engine(case):
    """Both engines solve the same KKT system: their solutions agree at
    5e-6, both converged."""
    jqp = (make_qp(np.random.default_rng(11)) if case == "random"
           else jax_qp("usv_guidance_ca1", 12))
    qp = port_qp(jqp)
    s_ric = ipm.ipm_solve(qp, iters=30)
    s_den = dense_qp.dense_qp_solve(qp, iters=30)
    assert int(s_ric.status) == 0 and int(s_den.status) == 0
    for a, b in ((s_den.dx, s_ric.dx), (s_den.du, s_ric.du)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-6)


def test_nan_measurement_is_status_2():
    """A NaN dx0 freezes w at a finite value but expands to a non-finite
    dx: status 2, as in the Riccati engine."""
    jqp = make_qp(np.random.default_rng(12))
    jqp = jqp._replace(dx0=jqp.dx0.at[0].set(jnp.nan))
    got = dense_qp.dense_qp_solve(port_qp(jqp), iters=6)
    assert int(got.status) == int(jdense.dense_qp_solve(jqp, iters=6)
                                  .status) == 2
