"""The per-instance interior-point QP solver `ops/ipm.py::ipm_solve` vs the
JAX package's, float64 on the CPU at atol 1e-8 with identical status, on
QPs that JAX's `build_qp` assembles (carried over through
`interop.qp_data_from_numpy`): fixed centering on the flagship, Mehrotra
on usv_guidance_ca's hard rows, mu0="auto" on usv_position_control's
1e5-scale weights, the hull's hard rows, race_cars_dev's soft state box,
a batch against `jax.vmap`, and a NaN measurement (status 2)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import ipm as jipm
from mpc_collisionavoidance_tpu.ops import linearize as jlin
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.ops import ipm
from mpc_collisionavoidance_tpu_torch.sim import scenarios

TOL = 1e-8


def jax_qp(name, N, batch=None, seed=0, nan_dx0=False):
    """JAX's QP of `name` at a perturbed warm start of its scenario (one
    instance, or a `batch` of them stacked by `jax.vmap`)."""
    spec = jbuilders.build(name, N=N)
    m = spec.model
    sc = scenarios.DEFAULTS[name][0]()
    rng = np.random.default_rng(seed)
    shape = () if batch is None else (batch,)
    xbar = np.asarray(sc.x0, float) + 0.05 * rng.standard_normal(
        shape + (N + 1, m.nx))
    ubar = 0.05 * rng.standard_normal(shape + (N, m.nu))
    x0 = xbar[..., 0, :] + 0.05 * rng.standard_normal(shape + (m.nx,))
    if nan_dx0:
        x0[..., 1] = np.nan
    yref = np.broadcast_to(spec.cost.yref, shape + (N, spec.cost.ny))
    yref_e = np.broadcast_to(spec.cost.yref_e,
                             shape + (len(spec.cost.yref_e),))
    params = np.broadcast_to(sc.params if np.size(sc.params)
                             else np.zeros(m.np_), shape + (m.np_,))
    fn = functools.partial(jlin.build_qp, spec, jlin.make_row_layout(spec))
    if batch is not None:
        fn = jax.vmap(fn)
    return jax.jit(fn)(*(jnp.asarray(a) for a in (xbar, ubar, x0, yref,
                                                  yref_e, params)))


def port_qp(qp):
    return interop.qp_data_from_numpy(
        {k: np.asarray(v) for k, v in qp._asdict().items()}, device="cpu",
        dtype=torch.float64)


def _solve_both(qp, batched=False, **kw):
    fn = functools.partial(jipm.ipm_solve, **kw)
    want = jax.jit(jax.vmap(fn) if batched else fn)(qp)
    return ipm.ipm_solve(port_qp(qp), **kw), want


def _close(got, want):
    for field in ("dx", "du", "sl", "su", "gap", "eq_res"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL,
                                   err_msg=field)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))


CASES = {
    # case: (model, N, ipm_solve keywords)
    "fixed_flagship": ("usv_guidance_ca1", 20, dict(iters=18)),
    "mehrotra_guidance_ca": ("usv_guidance_ca", 20,
                             dict(iters=12, centering="mehrotra")),
    "mu0_auto_position_control": ("usv_position_control", 20,
                                  dict(iters=18, centering="mehrotra",
                                       mu0="auto")),
    "mu0_auto_fixed_position_control": ("usv_position_control", 20,
                                        dict(iters=18, mu0="auto")),
    "hull_hard_rows": ("usv_pf_ca", 15, dict(iters=18)),
    "race_cars_dev_soft_box": ("race_cars_dev", 10, dict(iters=20)),
    "no_rows_usv_guidance4": ("usv_guidance4", 15, dict(iters=12)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ipm_matches_jax(case):
    name, N, kw = CASES[case]
    got, want = _solve_both(jax_qp(name, N), **kw)
    _close(got, want)


def test_ipm_families_are_what_the_cases_claim():
    """The hull QP has hard rows and no soft ones (nS = 0: the empty
    family's fraction-to-boundary is +inf), race_cars_dev's a soft state
    box, usv_guidance4's neither hard h nor soft rows."""
    hull = port_qp(jax_qp("usv_pf_ca", 15))
    assert hull.Gx.shape[-2] == 2 * 2 + 2 * 5 + 2 * 4
    assert hull.Cx.shape[-2] == 0
    dev = port_qp(jax_qp("race_cars_dev", 10))
    assert dev.Cx.shape[-2] == 6
    g4 = port_qp(jax_qp("usv_guidance4", 15))
    assert g4.Cx.shape[-2] == 0


@pytest.mark.parametrize("centering", ["fixed", "mehrotra"])
def test_batch_matches_jax_vmap(centering):
    """Per-instance step sizes, gaps and statuses over a batch of 3."""
    qp = jax_qp("usv_guidance_ca1", 15, batch=3, seed=4)
    got, want = _solve_both(qp, batched=True, iters=10, centering=centering)
    assert tuple(got.gap.shape) == (3,)
    _close(got, want)


@pytest.mark.parametrize("centering", ["fixed", "mehrotra"])
def test_nan_measurement_is_status_2(centering):
    """A NaN in the measurement (dx0) freezes the iterate at a finite
    value; the non-finite residual surfaces as status 2, in JAX and in the
    port; in a batch only that instance."""
    qp = jax_qp("usv_guidance_ca1", 10, seed=5, nan_dx0=True)
    got, want = _solve_both(qp, iters=6, centering=centering)
    assert int(got.status) == int(want.status) == 2
    qp = jax_qp("usv_guidance_ca1", 10, batch=3, seed=5)
    bad = qp._replace(dx0=qp.dx0.at[1, 0].set(jnp.nan))
    got, want = _solve_both(bad, batched=True, iters=6, centering=centering)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    assert int(got.status[1]) == 2
    assert set(got.status[[0, 2]].tolist()) <= {0, 1}


def test_unknown_schedule_raises():
    qp = port_qp(jax_qp("usv_guidance_ca1", 5))
    with pytest.raises(ValueError, match="centering"):
        ipm.ipm_solve(qp, centering="adaptive")
    with pytest.raises(ValueError, match="mu0"):
        ipm.ipm_solve(qp, mu0="warm")
