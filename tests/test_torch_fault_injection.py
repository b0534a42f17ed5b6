"""Fault injection on the port: the NaN quarantine is per vehicle
(counterpart of tests/test_fault_injection.py).

The reference's only failure handling is a logged nonzero acados status
with the stale command left in effect (SURVEY.md section 5).  On the
port's engines a poisoned instance must (a) read status 2 and (b) leave
the other instances of the same batched solve untouched: the fleet keeps
flying when one vehicle's sensor emits garbage.  The inputs are the JAX
file's (the flagship's default scenario, seed 5, N=25, Tf=2, float64 on
the CPU); the production schedule's case is held against JAX's lane
engine on the same poisoned batch, escalation count included (a dead
lane must not drive the escalation, `ops/ipm_lanes.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu_torch.config import production_engine
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           from_lanes,
                                                           to_lanes)
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
from tests.test_torch_escalation import jax_escalations  # noqa: F401
from tests.torch_guidance import jax_production_kw, one_torch_thread  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)


def _inputs(B):
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(5)
    x0s = np.broadcast_to(sc.x0, (B, 8)).astype(np.float64).copy()
    x0s[:, 2] += 0.1 * rng.standard_normal(B)
    params = np.broadcast_to(sc.params, (B, 16)).astype(np.float64)
    lhs = np.broadcast_to(sc.lh, (B, 8)).astype(np.float64)
    return x0s, params, lhs


def _lane_tick(solver, x0s, params, lhs):
    """One lane-engine tick from the cold start at the clean x0s: (u0
    (B, nu), status (B,), the tick's escalation iterations)."""
    state = solver.init_state(_inputs(len(x0s))[0])
    _, out = solver.step_fn(state, *(to_lanes(torch.as_tensor(a))
                                     for a in (x0s, params, lhs)))
    return (from_lanes(out.u0).numpy(), out.status.numpy(),
            int(solver.last_esc_iters))


def _instance_tick(solver, x0s, params, lhs):
    """One batched `RTISolver` tick (the counterpart of
    `jax.vmap(solver.step_fn)`) from the cold start at the clean x0s."""
    state = solver.init_state(_inputs(len(x0s))[0])
    _, out = solver.step_fn(state, *(torch.as_tensor(a)
                                     for a in (x0s, params, lhs)))
    return out.u0.numpy(), out.status.numpy(), 0


# engine -> (batch, poisoned instance, poisoned coordinate, solver, tick)
ENGINES = {
    "lane": (8, 3, 0, lambda spec: LaneRTISolver(spec, ipm_iters=15, **F64),
             _lane_tick),
    "instance": (6, 0, 1, lambda spec: RTISolver(spec, ipm_iters=15, **F64),
                 _instance_tick),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_nan_quarantine(engine):
    """15 fixed IPM iterations: the poisoned instance reads status 2, no
    other does, and the healthy instances' u0 equal the clean batch's
    bitwise and are finite."""
    B, bad, coord, make, tick = ENGINES[engine]
    solver = make(builders.usv_guidance_ca1(Tf=2.0, N=25))
    x0s, params, lhs = _inputs(B)
    u0_clean, _, _ = tick(solver, x0s, params, lhs)
    x0s_bad = x0s.copy()
    x0s_bad[bad, coord] = np.nan              # poisoned measurement
    u0, status, _ = tick(solver, x0s_bad, params, lhs)

    assert status[bad] == 2, status
    ok = np.arange(B) != bad
    assert np.all(status[ok] != 2), status
    np.testing.assert_array_equal(u0[ok], u0_clean[ok])
    assert np.all(np.isfinite(u0[ok]))


def test_dense_engine_nan_quarantine():
    """The dense (qpOASES-role) backend flags a NaN-poisoned problem with
    status 2 as well (N=10, 20 iterations)."""
    solver = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=10),
                       ipm_iters=20, qp_backend="dense", **F64)
    sc = scenarios.guidance_ca1_default()
    x0 = np.asarray(sc.x0, np.float64).copy()
    st = solver.init_state(x0)
    p, lh = torch.as_tensor(sc.params), torch.as_tensor(sc.lh)
    _, ok_out = solver.step_fn(st, torch.as_tensor(x0), p, lh)
    assert int(ok_out.status) in (0, 1)
    x0[4] = np.nan
    _, bad_out = solver.step_fn(st, torch.as_tensor(x0), p, lh)
    assert int(bad_out.status) == 2


def test_production_tick_quarantine_matches_jax(jax_escalations):  # noqa: F811
    """The production schedule (adaptive centering, mu0 auto, 4 fixed
    iterations, escalation while any gap exceeds 3e-6) on the lane batch
    with lane 3 poisoned: the port's tick equals JAX's lane engine on the
    same batch within 5e-6 with identical status and the same escalation
    count, which is the clean batch's (the dead lane does not drive the
    escalation); the poisoned lane reads status 2 and the others keep the
    clean batch's u0 bitwise."""
    B, bad = 8, 3
    x0s, params, lhs = _inputs(B)
    x0s_bad = x0s.copy()
    x0s_bad[bad, 0] = np.nan
    port = production_engine().build(builders.usv_guidance_ca1(Tf=2.0, N=25),
                                     **F64)
    u0_clean, _, esc_clean = _lane_tick(port, x0s, params, lhs)
    u0, status, esc = _lane_tick(port, x0s_bad, params, lhs)

    jax_lane = JaxLane(jbuilders.usv_guidance_ca1(Tf=2.0, N=25),
                       **jax_production_kw())
    jstate = jax_lane.init_state(x0s, dtype=jnp.float64)
    jax_escalations.clear()
    _, jout = jax_lane.step_fn(jstate, *(jax_lanes(jnp.asarray(a))
                                         for a in (x0s_bad, params, lhs)))
    ju0 = np.asarray(jout.u0).T
    assert jax_escalations == [esc] and esc == esc_clean, (
        jax_escalations, esc, esc_clean)
    np.testing.assert_array_equal(status, np.asarray(jout.status))
    assert status[bad] == 2 and np.all(np.delete(status, bad) != 2), status
    ok = np.arange(B) != bad
    np.testing.assert_allclose(u0[ok], ju0[ok], rtol=0, atol=5e-6)
    assert np.all(np.isnan(u0[bad])) and np.all(np.isnan(ju0[bad]))
    np.testing.assert_array_equal(u0[ok], u0_clean[ok])
