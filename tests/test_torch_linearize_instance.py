"""The per-instance QP assembly `ops/linearize.py::build_qp` vs the JAX
package's `ops/linearize.py::build_qp`, float64 on the CPU at N=10: every
QPData field of every model of the zoo (the builders' 14 OCPs) and of
the race car on the curved track, at 1e-12 (relative too: the hulls'
stiff sway-drag Jacobian entries are large)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import linearize as jlin
from mpc_collisionavoidance_tpu.utils import track as jtrack
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops import linearize
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.utils import track as trk

N = 10
TOL = 1e-12
CASES = sorted(builders.BUILDERS) + ["race_cars_track"]


def _specs(case):
    name = case.replace("_track", "")
    if case.endswith("_track"):
        return (builders.build(name, N=N, track=trk.make_synthetic_track()),
                jbuilders.build(name, N=N,
                                track=jtrack.make_synthetic_track()))
    return builders.build(name, N=N), jbuilders.build(name, N=N)


def _inputs(spec, case, batch, seed):
    """An iterate around the scenario's start: xbar = x0 + 0.05 N(0, 1)
    per stage, ubar 0.05 N(0, 1), the measurement 0.01 off stage 0, a
    stage reference that moves along the horizon, the scenario's params
    and its lh (None for a model with no rows)."""
    m = spec.model
    sc = scenarios.DEFAULTS[case.replace("_track", "")][0]()
    rng = np.random.default_rng(seed)
    xbar = sc.x0 + 0.05 * rng.standard_normal(batch + (N + 1, m.nx))
    ubar = 0.05 * rng.standard_normal(batch + (N, m.nu))
    x0 = xbar[..., 0, :] + 0.01 * rng.standard_normal(batch + (m.nx,))
    yref = (np.asarray(spec.cost.yref, float)
            + 0.1 * rng.standard_normal(batch + (N, spec.cost.ny)))
    yref_e = (np.asarray(spec.cost.yref_e, float)
              + 0.1 * rng.standard_normal(batch + (len(spec.cost.yref_e),)))
    params = np.broadcast_to(sc.params, batch + (m.np_,)).copy()
    lh = (np.broadcast_to(sc.lh, batch + (m.nh,)).copy() if m.nh else None)
    return xbar, ubar, x0, yref, yref_e, params, lh


def _port(spec, args):
    t = [None if a is None else torch.tensor(a) for a in args]
    return linearize.build_qp(spec, linearize.make_row_layout(spec), *t)


def _jax(spec, args, batched):
    fn = functools.partial(jlin.build_qp, spec, jlin.make_row_layout(spec))
    fn = jax.jit(jax.vmap(fn) if batched else fn)
    return fn(*(None if a is None else jnp.asarray(a) for a in args))


def _close(got, want):
    for field, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=field)


@pytest.mark.parametrize("case", CASES)
def test_build_qp_matches_jax(case):
    """A batch of two iterates in one call against `jax.vmap` of JAX's
    per-instance build_qp."""
    spec, jspec = _specs(case)
    args = _inputs(spec, case, (2,), seed=len(case))
    _close(_port(spec, args), _jax(jspec, args, batched=True))


def test_build_qp_unbatched_and_default_lh():
    """One iterate with no batch axes, the model's own lh (lh=None)."""
    spec, jspec = _specs("usv_pf_ca")
    args = list(_inputs(spec, "usv_pf_ca", (), seed=3))
    args[-1] = None
    _close(_port(spec, args), _jax(jspec, args, batched=False))


def test_row_layout_matches_jax():
    for case in CASES:
        spec, jspec = _specs(case)
        for a, b in zip(linearize.make_row_layout(spec),
                        jlin.make_row_layout(jspec)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
