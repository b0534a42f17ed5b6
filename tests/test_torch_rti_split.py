"""The RTI preparation/feedback split of the port's lane engine
(`LaneRTISolver.prepare_fn` / `feedback_fn`): it composes to `step_fn`,
and it matches the JAX package's split, float64 on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu_torch.config import production_engine
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import scenarios

N, B = 20, 4
# OCP -> (Tf keeping the reference's stage length, scenario, ye index)
OCPS = {"usv_guidance_ca1": (1.0, scenarios.guidance_ca1_default, 2),
        "usv_pf_ca": (0.2, scenarios.pf_ca_default, 6)}


def _inputs(name, seed):
    """Lane inputs (numpy, lane layout): the start x0s, a fresh
    measurement x0 that differs from the warm start, params, lh and a
    per-lane yref (the scenario's, or the builder's, with lane noise)."""
    Tf, scenario, ye = OCPS[name]
    spec = builders.build(name, Tf=Tf, N=N)
    sc, m = scenario(), spec.model
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (B, m.nx)).copy()
    x0s[:, ye] += 0.2 * rng.standard_normal(B)
    x_meas = x0s + 0.05 * rng.standard_normal(x0s.shape)
    yref = sc.yref if sc.yref is not None else spec.cost.yref
    yrefL = (np.asarray(yref)[:, None]
             + 0.01 * rng.standard_normal((len(yref), B)))
    lanes = lambda a: np.ascontiguousarray(np.broadcast_to(a, (B, len(a))).T)
    return (x0s, x_meas.T.copy(), lanes(sc.params), lanes(sc.lh), yrefL,
            yrefL[:m.nx])


def _port_solver(name):
    Tf = OCPS[name][0]
    return production_engine().build(builders.build(name, Tf=Tf, N=N),
                                     device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("name", sorted(OCPS))
def test_prepare_feedback_equals_step(name):
    """After one warm tick, prepare + feedback at a fresh x0 reproduce
    step_fn at that x0."""
    solver = _port_solver(name)
    x0s, *rest = _inputs(name, 0)
    x_meas, p, lh, yref, yref_e = map(torch.as_tensor, rest)
    kw = dict(yref=yref, yref_e=yref_e)
    st, _ = solver.step_fn(solver.init_state(x0s), torch.as_tensor(x0s).T,
                           p, lh, **kw)
    st_s, out_s = solver.step_fn(st, x_meas, p, lh, **kw)
    qp = solver.prepare_fn(st, p, lh, **kw)
    st_f, out_f = solver.feedback_fn(st, qp, x_meas)
    for a, b in ((out_f.u0, out_s.u0), (out_f.x1, out_s.x1),
                 (st_f.xbar, st_s.xbar), (st_f.ubar, st_s.ubar)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    assert torch.equal(out_f.status, out_s.status)


@pytest.mark.parametrize("name", sorted(OCPS))
def test_prepare_feedback_matches_jax(name):
    """The port's split against JAX's prepare_fn/feedback_fn on the same
    warm start, production schedule, at the lane engine's tolerance
    (tests/test_lane_engine.py)."""
    Tf = OCPS[name][0]
    x0s, x_meas, p, lh, yref, yref_e = _inputs(name, 1)
    eng = dataclasses.asdict(production_engine())
    eng.pop("riccati")                 # the sweep backend, JAX's "lax"
    del eng["engine"], eng["qp_backend"]   # the engine choice, not its args
    js = JaxLane(jbuilders.build(name, Tf=Tf, N=N), **eng)
    jst = js.init_state(x0s, dtype=jnp.float64)
    jqp = js.prepare_fn(jst, jnp.asarray(p), jnp.asarray(lh),
                        yref=jnp.asarray(yref), yref_e=jnp.asarray(yref_e))
    jst, out_j = js.feedback_fn(jst, jqp, jnp.asarray(x_meas))

    ts = _port_solver(name)
    tst = ts.init_state(x0s)
    tqp = ts.prepare_fn(tst, torch.as_tensor(p), torch.as_tensor(lh),
                        yref=torch.as_tensor(yref),
                        yref_e=torch.as_tensor(yref_e))
    tst, out_t = ts.feedback_fn(tst, tqp, torch.as_tensor(x_meas))
    for field in ("u0", "x1"):
        np.testing.assert_allclose(getattr(out_t, field).numpy(),
                                   np.asarray(getattr(out_j, field)),
                                   rtol=0, atol=5e-6, err_msg=field)
    np.testing.assert_allclose(tst.xbar.numpy(), np.asarray(jst.xbar),
                               rtol=0, atol=5e-6)
    np.testing.assert_array_equal(out_t.status.numpy(),
                                  np.asarray(out_j.status))


def test_prepared_qp_holds_no_view_of_the_state():
    """A prepared QP keeps its values when the state it was built from is
    then written in place (as a server seeds a joining lane's warm
    start)."""
    solver = _port_solver("usv_guidance_ca1")
    x0s, _, p, lh, _, _ = _inputs("usv_guidance_ca1", 2)
    st = solver.init_state(x0s)
    qp = solver.prepare_fn(st, torch.as_tensor(p), torch.as_tensor(lh))
    before = {k: v.clone() for k, v in qp._asdict().items()
              if v is not None}
    st.xbar[:, :, 1] = 7.0
    st.ubar[:, :, 1] = 0.3
    for k, v in before.items():
        assert torch.equal(getattr(qp, k), v), k
