"""The port's per-instance SQP-RTI engine (`solver/sqp_rti.py::RTISolver`)
vs the JAX package's, float64 on the CPU: warm-started ticks of step_fn
at atol 1e-8 with identical status, the preparation/feedback split, the
converged and damped SQP loops, race_cars_dev's soft-box SQP
(tests/test_soft_box.py), a batch against per-instance calls, and the
engine's configuration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver as JaxRTI
from mpc_collisionavoidance_tpu_torch.config import SolverConfig
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import (RTISolver,
                                                             SolverState)

TOL = 1e-8
F64 = torch.float64


def _scenario(name, N):
    """(x0, params, lh, yref, yref_e) of the model's scenario as numpy
    (lh, yref, yref_e None where it has none)."""
    sc = scenarios.DEFAULTS[name][0]()
    lh = sc.lh if np.size(sc.lh) else None
    yref = None if sc.yref is None else np.tile(sc.yref, (N, 1))
    return sc.x0, np.asarray(sc.params, float), lh, yref, sc.yref_e


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_out(got, want, atol=TOL):
    for field in ("u0", "x1", "xtraj", "utraj", "qp_gap"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), rtol=0,
                                   atol=atol, err_msg=field)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))


TICKS = {
    # case: (model, Tf, N, RTISolver keywords)
    "flagship": ("usv_guidance_ca1", 1.0, 20, {}),
    "hull": ("usv_pf_ca", 1.0, 15, {}),
    "guidance_ca_mehrotra": ("usv_guidance_ca", 2.0, 20,
                             dict(centering="mehrotra")),
    "position_control_auto": ("usv_position_control", 1.0, 12,
                              dict(centering="mehrotra", mu0="auto")),
    "flagship_dense": ("usv_guidance_ca1", 1.0, 12,
                       dict(qp_backend="dense")),
}


@pytest.mark.parametrize("case", sorted(TICKS))
def test_three_ticks_match_jax(case):
    """Three warm-started closed-loop ticks (x0 <- x1) from the scenario."""
    name, Tf, N, kw = TICKS[case]
    js = JaxRTI(jbuilders.build(name, Tf=Tf, N=N), **kw)
    ts = RTISolver(builders.build(name, Tf=Tf, N=N), **kw, device="cpu",
                   dtype=F64)
    x0, p, lh, yref, yref_e = _scenario(name, N)
    jst = js.init_state(jnp.asarray(x0), dtype=jnp.float64)
    tst = ts.init_state(x0)
    step = jax.jit(js.step_fn)
    x = np.asarray(x0, float)
    for _ in range(3):
        jst, jout = step(jst, jnp.asarray(x), jnp.asarray(p), _j(lh),
                         _j(yref), _j(yref_e))
        tst, tout = ts.step_fn(tst, x, p, lh, yref, yref_e)
        _assert_out(tout, jout)
        x = np.asarray(jout.x1)


def test_per_stage_reference_matches_jax():
    """The race car's receding progress reference: a yref that differs
    per stage (the golden's `_race_yref_fn`) and yref_e."""
    js = JaxRTI(jbuilders.build("race_cars", Tf=0.4, N=10))
    ts = RTISolver(builders.build("race_cars", Tf=0.4, N=10), device="cpu",
                   dtype=F64)
    x0 = np.array([0.0, 0.05, 0.0, 0.5, 0.1, 0.0])
    yref = np.zeros((10, 8))
    yref[:, 0] = 3.0 * np.arange(10) / 10
    yref_e = np.zeros(6)
    yref_e[0] = 3.0
    _, jout = jax.jit(js.step_fn)(
        js.init_state(jnp.asarray(x0), dtype=jnp.float64), jnp.asarray(x0),
        jnp.zeros(0), None, jnp.asarray(yref), jnp.asarray(yref_e))
    _, tout = ts.step_fn(ts.init_state(x0), x0, np.zeros(0), None, yref,
                         yref_e)
    _assert_out(tout, jout)


def test_prepare_feedback_equals_step():
    """prepare_fn + feedback_fn == step_fn bitwise, with a measurement
    off the predicted state, after two warm-up ticks."""
    spec = builders.usv_guidance_ca1(Tf=2.0, N=25)
    solver = RTISolver(spec, ipm_iters=15, device="cpu", dtype=F64)
    x0, p, lh, _, _ = _scenario("usv_guidance_ca1", 25)
    st = solver.init_state(x0)
    x = torch.tensor(x0)
    for _ in range(2):
        st, out = solver.step_fn(st, x, p, lh)
        x = out.x1
    x_meas = x + 0.01 * torch.arange(8, dtype=F64)
    st_j, out_j = solver.step_fn(st, x_meas, p, lh)
    st_s, out_s = solver.feedback_fn(st, solver.prepare_fn(st, p, lh),
                                     x_meas)
    for a, b in zip(out_s + st_s, out_j + st_j):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step_alpha", [1.0, 0.5])
def test_solve_converged_matches_jax(step_alpha):
    """Three SQP iterations from a cold start, full and damped: the
    output describes the (damped) iterate actually carried."""
    N = 20
    js = JaxRTI(jbuilders.usv_guidance_ca1(Tf=1.0, N=N), ipm_iters=15)
    ts = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=N), ipm_iters=15,
                   device="cpu", dtype=F64)
    x0, p, lh, _, _ = _scenario("usv_guidance_ca1", N)
    jst, jout = js.solve_converged(
        js.init_state(jnp.asarray(x0), dtype=jnp.float64), jnp.asarray(x0),
        jnp.asarray(p), jnp.asarray(lh), sqp_iters=3, step_alpha=step_alpha)
    tst, tout = ts.solve_converged(ts.init_state(x0), x0, p, lh,
                                   sqp_iters=3, step_alpha=step_alpha)
    _assert_out(tout, jout)
    assert torch.equal(tout.xtraj, tst.xbar)
    assert torch.equal(tout.utraj, tst.ubar)
    np.testing.assert_allclose(tst.xbar.numpy(), np.asarray(jst.xbar),
                               rtol=0, atol=TOL)


def test_race_cars_dev_converged_sqp():
    """tests/test_soft_box.py's spec on the port: converged SQP from a
    state outside the track bound pulls n back toward the soft band."""
    spec = builders.race_cars_dev(Tf=0.4, N=10)
    solver = RTISolver(spec, ipm_iters=20, device="cpu", dtype=F64)
    x0 = np.array([-2.0, 12.4, 0.0, 1.0, 0.0, 0.0])   # n outside ubx=12
    st, out = solver.solve_converged(solver.init_state(x0), x0, np.zeros(0),
                                     sqp_iters=25)
    assert int(out.status) == 0
    n_traj = out.xtraj[:, 1].numpy()
    assert np.all(n_traj[3:] <= 12.4)
    assert n_traj[-1] <= 12.1
    assert n_traj[-1] < n_traj[2] - 0.2
    assert float(out.utraj[:, 0].abs().max()) <= 10 + 1e-8
    assert float(out.utraj[:, 1].abs().max()) <= 2 + 1e-8


@pytest.mark.parametrize("backend", ["riccati", "dense"])
def test_batch_equals_per_instance_calls(backend):
    """One call on a batch of 5 (shared params, per-instance x0) against
    five unbatched calls: the batch axis is vmap's."""
    N = 12
    solver = RTISolver(builders.usv_guidance_ca1(Tf=1.0, N=N),
                       qp_backend=backend, device="cpu", dtype=F64)
    x0, p, lh, _, _ = _scenario("usv_guidance_ca1", N)
    xs = np.broadcast_to(x0, (5, 8)).copy()
    xs[:, 2] += 0.3 * np.random.default_rng(0).standard_normal(5)
    st, out = solver.step_fn(solver.init_state(xs), xs, p, lh)
    assert tuple(out.u0.shape) == (5, 1) and tuple(out.status.shape) == (5,)
    for i in range(5):
        st_i, out_i = solver.step_fn(solver.init_state(xs[i]), xs[i], p, lh)
        for a, b in zip(out + st, out_i + st_i):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=0,
                                       atol=1e-12)


def test_init_state_and_device_binding():
    spec = builders.usv_pf_ca(Tf=1.0, N=6)
    solver = SolverConfig(engine="instance").build(spec, device="cpu",
                                                   dtype=torch.float32)
    assert isinstance(solver, RTISolver)
    st = solver.init_state(np.ones((3, 14)))
    assert isinstance(st, SolverState)
    assert st.xbar.shape == (3, 7, 14) and st.xbar.dtype == torch.float32
    assert st.ubar.shape == (3, 6, 2) and not st.ubar.any()
    assert solver.init_state(np.ones(14)).xbar.shape == (7, 14)


def test_schedule_validation():
    spec = builders.usv_guidance_ca1(Tf=1.0, N=5)
    with pytest.raises(ValueError, match="qp_backend"):
        RTISolver(spec, qp_backend="qpoases", device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="centering"):
        RTISolver(spec, centering="adaptive", device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="riccati backend only"):
        RTISolver(spec, qp_backend="dense", centering="mehrotra",
                  device="cpu", dtype=F64)
    # the JAX package's engine checks (config.py:47-83)
    with pytest.raises(ValueError, match="engine"):
        SolverConfig(engine="vmap")
    with pytest.raises(ValueError, match="adaptive"):
        SolverConfig(engine="instance", centering="adaptive")
    with pytest.raises(ValueError, match="extra_iters"):
        SolverConfig(engine="instance", extra_iters=4)
    with pytest.raises(ValueError, match="lane engine"):
        SolverConfig(engine="instance", riccati="fused")
    with pytest.raises(ValueError, match="instance engine"):
        SolverConfig(qp_backend="dense")
    with pytest.raises(ValueError, match="qp_backend"):
        SolverConfig(engine="instance", qp_backend="sparse")
    dense = SolverConfig(engine="instance", qp_backend="dense").build(
        spec, device="cpu", dtype=F64)
    assert (dense.qp_backend, dense.ipm_iters) == ("dense", 12)
