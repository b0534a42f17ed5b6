"""The port's production RTI tick (the slice as a whole) vs the JAX
package's `LaneRTISolver`, float64 on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu import config as jconfig
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.sim import scenarios as jscenarios
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import to_lanes as jax_lanes
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import (SolverConfig,
                                                     production_engine)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           from_lanes,
                                                           to_lanes)


def _jax_production_kw():
    pe = jconfig.production_engine("cpu")
    return dict(ipm_iters=pe.ipm_iters, ipm_tol=pe.ipm_tol,
                centering=pe.centering, mu0=pe.mu0,
                extra_iters=pe.extra_iters, stall_tol=pe.stall_tol)


def _inputs(B, seed):
    sc = jscenarios.guidance_ca1_default()
    rng = np.random.default_rng(seed)
    x0s = np.broadcast_to(sc.x0, (B, 8)).copy()
    x0s[:, 2] += 0.2 * rng.standard_normal(B)
    params = np.broadcast_to(sc.params, (B, 16)).copy()
    lhs = np.broadcast_to(sc.lh, (B, 8)).copy()
    return x0s, params, lhs


def _jax_setup(spec, x0s, params, lhs, **kw):
    solver = JaxLane(spec, **kw)
    st = solver.init_state(x0s, dtype=jnp.float64)
    return (solver, st, jax_lanes(jnp.asarray(x0s, jnp.float64)),
            jax_lanes(jnp.asarray(params, jnp.float64)),
            jax_lanes(jnp.asarray(lhs, jnp.float64)))


def _port_setup(spec, x0s, params, lhs):
    solver = production_engine().build(spec, device="cpu",
                                       dtype=torch.float64)
    return (solver, solver.init_state(x0s),
            *(to_lanes(torch.as_tensor(a)) for a in (x0s, params, lhs)))


def _assert_outputs(out_t, out_j, atol=5e-6):
    np.testing.assert_allclose(out_t.u0.numpy(), np.asarray(out_j.u0),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(out_t.x1.numpy(), np.asarray(out_j.x1),
                               rtol=0, atol=atol)
    np.testing.assert_array_equal(out_t.status.numpy(),
                                  np.asarray(out_j.status))


def test_production_schedule_matches_jax():
    ours = dataclasses.asdict(production_engine())
    # the per-iteration sweep backend, JAX's "lax"/"pallas"
    assert ours.pop("riccati") == "sweep"
    assert ours == _jax_production_kw()


def test_closed_loop_matches_jax_lax_path():
    """3 warm-started closed-loop ticks (x0 <- x1), production schedule."""
    x0s, params, lhs = _inputs(B=5, seed=0)
    js, jst, jx, jp, jlh = _jax_setup(
        jbuilders.usv_guidance_ca1(Tf=2.0, N=25), x0s, params, lhs,
        **_jax_production_kw())
    ts, tst, tx, tp, tlh = _port_setup(builders.usv_guidance_ca1(Tf=2.0,
                                                                  N=25),
                                       x0s, params, lhs)
    for _ in range(3):
        jst, out_j = js.step_fn(jst, jx, jp, jlh)
        tst, out_t = ts.step_fn(tst, tx, tp, tlh)
        _assert_outputs(out_t, out_j)
        jx, tx = out_j.x1, out_t.x1
    np.testing.assert_allclose(tst.xbar.numpy(), np.asarray(jst.xbar),
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(out_t.gap.numpy(), np.asarray(out_j.gap),
                               rtol=1e-6)


def test_tick_matches_jax_pallas_interpret():
    """JAX with both Pallas kernels (interpret mode, polynomial atan2) vs
    the port's plain path."""
    x0s, params, lhs = _inputs(B=4, seed=1)
    js, jst, jx, jp, jlh = _jax_setup(
        jbuilders.usv_guidance_ca1(Tf=2.0, N=10), x0s, params, lhs,
        riccati="pallas_interpret", linearize="pallas_interpret",
        **_jax_production_kw())
    ts, tst, tx, tp, tlh = _port_setup(builders.usv_guidance_ca1(Tf=2.0,
                                                                  N=10),
                                       x0s, params, lhs)
    _, out_j = js.step_fn(jst, jx, jp, jlh)
    _, out_t = ts.step_fn(tst, tx, tp, tlh)
    np.testing.assert_allclose(out_t.u0.numpy(), np.asarray(out_j.u0),
                               rtol=1e-4, atol=1e-5)


def test_resume_jax_state_in_port():
    """Tick 1 in JAX, its LaneState carried across as numpy, tick 2 in the
    port: the same as tick 2 in JAX."""
    x0s, params, lhs = _inputs(B=3, seed=2)
    spec_kw = dict(Tf=2.0, N=25)
    js, jst, jx, jp, jlh = _jax_setup(jbuilders.usv_guidance_ca1(**spec_kw),
                                      x0s, params, lhs,
                                      **_jax_production_kw())
    jst, out1 = js.step_fn(jst, jx, jp, jlh)
    ts, _, _, tp, tlh = _port_setup(builders.usv_guidance_ca1(**spec_kw),
                                    x0s, params, lhs)
    tst = interop.lane_state_from_numpy(np.asarray(jst.xbar),
                                        np.asarray(jst.ubar), device="cpu",
                                        dtype=torch.float64)
    tx = torch.as_tensor(np.array(out1.x1))
    _, out_j = js.step_fn(jst, out1.x1, jp, jlh)
    _, out_t = ts.step_fn(tst, tx, tp, tlh)
    _assert_outputs(out_t, out_j)


def test_solver_is_bound_to_its_device_and_dtype():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=5)
    solver = SolverConfig().build(spec, device="cpu", dtype=torch.float32)
    assert solver.Qc.dtype == torch.float32
    assert solver.Qc.device == torch.device("cpu")
    st = solver.init_state(np.zeros((2, 8)))
    assert st.xbar.shape == (8, 6, 2) and st.xbar.dtype == torch.float32
    assert torch.equal(from_lanes(st.xbar)[:, 0, :],
                       torch.zeros((2, 6), dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="mehrotra"):
        LaneRTISolver(spec, centering="mehrotra", device="cpu",
                      dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="mehrotra"):
        SolverConfig(centering="mehrotra")
    with pytest.raises(ValueError, match="mu0"):
        SolverConfig(mu0="warm")
