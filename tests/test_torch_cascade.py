"""The port's inner-loop node (`guidance/low_level.py`) and two-rate
cascade (`sim/cascade.py`) vs the JAX package's, float64 on the CPU; the
JAX suite's cascade mission property on the port (`slow`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance import GuidanceController as JaxCtrl
from mpc_collisionavoidance_tpu.guidance.low_level import (
    LowLevelController as JaxLow)
from mpc_collisionavoidance_tpu.guidance.low_level import (
    LowLevelMeasurements as JaxLowMeas)
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops.integrators import rk4_step as jrk4
from mpc_collisionavoidance_tpu.sim import cascade as jcascade
from mpc_collisionavoidance_tpu_torch.guidance import GuidanceController
from mpc_collisionavoidance_tpu_torch.guidance.low_level import (
    LowLevelController, LowLevelMeasurements)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.ops.integrators import rk4_step
from mpc_collisionavoidance_tpu_torch.sim import cascade, scenarios
from tests.torch_guidance import one_torch_thread  # noqa: F401

F64 = torch.float64
WPS = np.array([[4.0, -5.0], [4.0, 25.0]])
HULL0 = (0.0, 0.001, 0.0, 0.0, 0.0, 0.0)


def test_hull_dynamics_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        x = rng.normal(0, 1, 6)
        x[1] = rng.uniform(0.0, 2.0)                  # both drag branches
        thr = rng.uniform(-30, 35, 2)
        got = rk4_step(cascade.hull_dynamics, torch.as_tensor(x),
                       torch.as_tensor(thr), torch.zeros(0, dtype=F64), 0.01)
        want = jrk4(jcascade.hull_dynamics, jnp.asarray(x), jnp.asarray(thr),
                    None, 0.01)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)


def test_low_level_ticks_match_jax():
    """Ten inner-loop ticks at N=20 holding psi_d = 0.4, u_d = 1.0
    against the true hull (tests/test_cascade.py's standalone loop):
    thrusts and telemetry at 1e-6, identical status, same memory."""
    jll = JaxLow(jbuilders.usv_low_level(Tf=1.0, N=20), ipm_iters=8)
    ll = LowLevelController(builders.usv_low_level(Tf=1.0, N=20),
                            ipm_iters=8, device="cpu", dtype=F64)
    h = np.array([0.0, 0.001, 0.0, 0.0, 0.0, 0.0])
    jst = jll.init_state(JaxLowMeas(*map(jnp.asarray, h[:4])),
                         dtype=jnp.float64)
    st = ll.init_state(LowLevelMeasurements(*h[:4]))
    jtick = jax.jit(jll.tick)
    for _ in range(10):
        jst, jc = jtick(jst, JaxLowMeas(*map(jnp.asarray, h[:4])), 0.4, 1.0)
        st, c = ll.tick(st, LowLevelMeasurements(*h[:4]), 0.4, 1.0)
        for f in jc._fields:
            np.testing.assert_allclose(
                getattr(c, f).numpy(), np.asarray(getattr(jc, f)), rtol=0,
                atol=1e-6, err_msg=f)
        np.testing.assert_allclose(st.past_t_port.numpy(),
                                   np.asarray(jst.past_t_port), atol=1e-6)
        h = np.asarray(jrk4(jcascade.hull_dynamics, jnp.asarray(h),
                            jnp.stack([jc.t_port, jc.t_stbd]), None, 0.01))


def test_low_level_zero_speed_override():
    """u_d == 0 hard-zeroes the published thrusts (reference
    nmpc_low_level.cpp:262-265) while the memory keeps the solver's
    stage-1 thrusts (tests/test_cascade.py's property, on the port)."""
    ll = LowLevelController(builders.usv_low_level(Tf=1.0, N=20),
                            ipm_iters=6, device="cpu", dtype=F64)
    meas = LowLevelMeasurements(psi=0.3, u=1.2, v=0.05, r=0.1)
    st = ll.init_state(meas)
    st, cmds = ll.tick(st, meas, 0.0, 0.0)
    assert float(cmds.t_port) == 0.0 and float(cmds.t_stbd) == 0.0
    assert np.isfinite(float(st.past_t_port))
    assert float(st.past_t_port) != 0.0


def test_run_cascade_matches_jax():
    """Ten guidance ticks (50 inner) of the cascade on the challenge-0
    course, guidance at N=25 and the low level at N=20: track, heading,
    speed, commands and thrusts at 1e-6, identical flags."""
    field, valid = scenarios.challenge0_field()
    jg = JaxCtrl(jbuilders.usv_guidance_ca1(Tf=2.0, N=25), ipm_iters=8)
    jll = JaxLow(jbuilders.usv_low_level(Tf=1.0, N=20), ipm_iters=6)
    want = jax.jit(lambda h: jcascade.run_cascade(
        jg, jll, h, WPS, 2, field, valid, n_steps=10, dtype=jnp.float64))(
        jcascade.HullState(*map(jnp.asarray, HULL0)))
    g = GuidanceController(builders.usv_guidance_ca1(Tf=2.0, N=25),
                           ipm_iters=8, device="cpu", dtype=F64)
    ll = LowLevelController(builders.usv_low_level(Tf=1.0, N=20),
                            ipm_iters=6, device="cpu", dtype=F64)
    got = cascade.run_cascade(g, ll, cascade.HullState(*HULL0), WPS, 2,
                              field, valid, n_steps=10)
    assert got.pos.shape == (10, 2) and got.thrust.shape == (10, 2)
    for f in ("pos", "psi", "u", "psi_d", "u_d", "thrust", "ye"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    for f in ("active", "collision"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert float(got.u.max()) > 0.05                  # the hull got going


def test_cascade_needs_one_device_and_dtype():
    g = GuidanceController(builders.usv_guidance_ca1(Tf=2.0, N=10),
                           device="cpu", dtype=F64)
    ll = LowLevelController(builders.usv_low_level(Tf=1.0, N=10),
                            device="cpu", dtype=torch.float32)
    field, valid = scenarios.challenge0_field()
    with pytest.raises(ValueError, match="different devices or dtypes"):
        cascade.run_cascade(g, ll, cascade.HullState(*HULL0), WPS, 2, field,
                            valid, n_steps=1)


@pytest.mark.slow
def test_cascade_mission_challenge0():
    """tests/test_cascade.py::test_cascade_mission_challenge0 on the port:
    900 guidance ticks through the challenge-0 buoy line."""
    g = GuidanceController(builders.usv_guidance_ca1(Tf=3.0, N=40),
                           ipm_iters=8, device="cpu", dtype=F64)
    ll = LowLevelController(builders.usv_low_level(Tf=1.0, N=40),
                            ipm_iters=6, device="cpu", dtype=F64)
    field, valid = scenarios.challenge0_field()
    log = cascade.run_cascade(g, ll, cascade.HullState(*HULL0), WPS, 2,
                              field, valid, n_steps=900)
    pos = log.pos.numpy()
    assert np.all(np.isfinite(pos))
    assert float(log.u.max()) > 0.6
    assert float(pos[-1, 1]) > 10.0, pos[-1]
    for (ox, oy, _), ok in zip(field, valid):
        if ok:
            dmin = float(np.min(np.hypot(pos[:, 0] - ox, pos[:, 1] - oy)))
            assert dmin > 1.1, (ox, oy, dmin)
    assert not log.collision.any()
