"""The port's mission harness (`sim/mission.py`) and closed-loop engine
(`sim/closed_loop.py`) vs the JAX package's, float64 on the CPU; and the
JAX suite's challenge-0 mission property on the port (`slow`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance import GuidanceController as JaxCtrl
from mpc_collisionavoidance_tpu.guidance import Measurements as JaxMeas
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.sim import closed_loop as jclosed
from mpc_collisionavoidance_tpu.sim import mission as jmission
from mpc_collisionavoidance_tpu.solver.sqp_rti import RTISolver as JaxRTI
from mpc_collisionavoidance_tpu_torch.guidance import GuidanceController
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import closed_loop, mission
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
from tests.torch_guidance import one_torch_thread  # noqa: F401

F64 = torch.float64
MEAS0 = (0.7, 0.0, 0.0, 0.0, 0.0)


def _challenge0():
    field, valid = scenarios.challenge0_field()
    return np.array([[4.0, -5.0], [4.0, 25.0]]), 2, field, valid


MISSIONS = {"challenge0": _challenge0, "autonav": scenarios.autonav_mission}


@pytest.mark.parametrize("name", sorted(MISSIONS))
def test_run_mission_matches_jax(name):
    """120 ticks at N=25, Tf=2 (the JAX suite's fleet-vs-missions
    tolerance, tests/test_fleet.py:41-46): track, heading and every
    command stream at 1e-6, identical status, activity and collision
    flags; the clearances agree."""
    wps, n_wp, field, valid = MISSIONS[name]()
    jctrl = JaxCtrl(jbuilders.usv_guidance_ca1(Tf=2.0, N=25), ipm_iters=12)
    want = jax.jit(lambda: jmission.run_mission(
        jctrl, JaxMeas(*MEAS0), wps, n_wp, field, valid, n_steps=120,
        dtype=jnp.float64))()
    ctrl = GuidanceController(builders.usv_guidance_ca1(Tf=2.0, N=25),
                              ipm_iters=12, device="cpu", dtype=F64)
    got = mission.run_mission(ctrl, MEAS0, wps, n_wp, field, valid,
                              n_steps=120)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               rtol=0, atol=1e-6)
    for f in ("psi_d", "r_d", "u_d", "ye", "target", "ak", "x0"):
        np.testing.assert_allclose(getattr(got.cmds, f).numpy(),
                                   np.asarray(getattr(want.cmds, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    for f in ("solver_status", "active", "collision"):
        np.testing.assert_array_equal(getattr(got.cmds, f).numpy(),
                                      np.asarray(getattr(want.cmds, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.final_state.mission.k.numpy(),
                                  np.asarray(want.final_state.mission.k))
    np.testing.assert_allclose(
        mission.min_obstacle_clearance(got, field, valid).numpy(),
        np.asarray(jmission.min_obstacle_clearance(want, field, valid)),
        rtol=0, atol=1e-6)
    if name == "autonav":
        assert int(got.final_state.mission.k) >= 2       # a switch ran


def test_batched_missions_match_jax_vmap():
    """Three starts in one batched RTISolver mission (the port's batch
    axes) against jax.vmap of the per-vehicle mission (log axes (T, B)
    vs (B, T))."""
    wps, n_wp, field, valid = _challenge0()
    B = 3
    meas0 = (np.full(B, 0.7), np.zeros(B), np.linspace(-1, 1, B),
             np.zeros(B), np.zeros(B))
    jctrl = JaxCtrl(jbuilders.usv_guidance_ca1(Tf=1.0, N=20), ipm_iters=10)
    want = jax.jit(jax.vmap(lambda m: jmission.run_mission(
        jctrl, m, wps, n_wp, field, valid, n_steps=40,
        dtype=jnp.float64)))(JaxMeas(*map(jnp.asarray, meas0)))
    ctrl = GuidanceController(builders.usv_guidance_ca1(Tf=1.0, N=20),
                              ipm_iters=10, device="cpu", dtype=F64)
    got = mission.run_mission(ctrl, meas0, wps, n_wp, field, valid,
                              n_steps=40)
    assert got.pos.shape == (40, B, 2)
    np.testing.assert_allclose(got.pos.numpy(),
                               np.asarray(want.pos).transpose(1, 0, 2),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.cmds.psi_d.numpy(),
                               np.asarray(want.cmds.psi_d).T, rtol=0,
                               atol=1e-6)
    assert not np.allclose(got.pos.numpy()[:, 0], got.pos.numpy()[:, 1])


# ---------------------------------------------------------------------------
# the closed-loop engine

def _flagship_loop_inputs():
    sc = scenarios.guidance_ca1_default()
    return sc.x0, sc.params, sc.lh


def _guidance_yref_fn(jax_side):
    """A per-tick reference from the measured state: usv_guidance's
    (sin, cos) heading slots aimed at the segment angle ak corrected by
    the cross-track error ye (any smooth function of the state serves)."""
    ny, nx, N = 11, 10, 20

    def fn(x, k):
        if jax_side:
            head = x[8] - 0.3 * jnp.tanh(x[7])
            yvec = (jnp.zeros((ny,), x.dtype).at[3].set(jnp.sin(head))
                    .at[4].set(jnp.cos(head)))
            return jnp.broadcast_to(yvec, (N, ny)), yvec[:nx]
        head = x[8] - 0.3 * torch.tanh(x[7])
        yvec = x.new_zeros(ny)
        yvec[3], yvec[4] = torch.sin(head), torch.cos(head)
        return yvec.expand(N, ny), yvec[:nx]

    return fn


LOOPS = {
    # case: (model, Tf, N, run_closed_loop keywords of both sides)
    "solver_prediction": ("usv_guidance_ca1", 2.0, 25, {}),
    "integrator_disturbed": ("usv_guidance_ca1", 2.0, 25,
                             dict(plant="integrator")),
    "yref_fn": ("usv_guidance", 1.0, 20, dict(plant="integrator")),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_run_closed_loop_matches_jax(case):
    """50 ticks of both plants, a per-step disturbance on the integrator
    plant, and a per-tick yref_fn: states, inputs and metrics at 1e-8,
    identical status."""
    name, Tf, N, kw = LOOPS[case]
    kw = dict(kw, n_steps=50, transient=10, metric_norm=40.0)
    if name == "usv_guidance_ca1":
        x0, p, lh = _flagship_loop_inputs()
    else:
        sc = scenarios.guidance_default()
        x0, p, lh = sc.x0.copy(), np.zeros(0), None
        x0[7] += 0.5
        kw["err_idx"] = (2, 7)
    jkw, tkw = dict(kw), dict(kw)
    if case == "integrator_disturbed":
        d = 1e-3 * np.random.default_rng(0).standard_normal((50, 8))
        jkw["disturbance"], tkw["disturbance"] = jnp.asarray(d), d
    if case == "yref_fn":
        jkw["yref_fn"] = _guidance_yref_fn(True)
        tkw["yref_fn"] = _guidance_yref_fn(False)
    js = JaxRTI(jbuilders.build(name, Tf=Tf, N=N), ipm_iters=12)
    want = jax.jit(lambda x: jclosed.run_closed_loop(
        js, x, p, None if lh is None else jnp.asarray(lh),
        dtype=jnp.float64, **jkw))(jnp.asarray(x0))
    ts = RTISolver(builders.build(name, Tf=Tf, N=N), ipm_iters=12,
                   device="cpu", dtype=F64)
    got = closed_loop.run_closed_loop(ts, x0, p, lh, **tkw)
    for f in ("simX", "simU", "psi_mae", "psi_mse", "ye_mae", "ye_mse"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_allclose(got.final_state.xbar.numpy(),
                               np.asarray(want.final_state.xbar), rtol=0,
                               atol=1e-8)


# ---------------------------------------------------------------------------
# the JAX suite's mission property (tests/test_guidance.py:145-168)

@pytest.mark.slow
def test_mission_closed_loop_challenge0():
    """Straight 30 m mission through the challenge-0 buoy line at N=60,
    Tf=3, 1200 ticks: reaches the final waypoint without entering any
    inflated buoy radius (minus the 0.2 m soft band)."""
    wps, n_wp, field, valid = _challenge0()
    ctrl = GuidanceController(builders.usv_guidance_ca1(Tf=3.0, N=60),
                              ipm_iters=10, device="cpu", dtype=F64)
    log = mission.run_mission(ctrl, MEAS0, wps, n_wp, field, valid,
                              n_steps=1200)
    pos = log.pos.numpy()
    assert np.all(np.isfinite(pos))
    active = log.cmds.active.numpy()
    assert not bool(active[-1])
    end = pos[np.argmax(~active)]
    assert np.hypot(end[0] - 4.0, end[1] - 25.0) < 1.2
    clear = mission.min_obstacle_clearance(log, field, valid).numpy()
    assert np.all(clear[:4] > 1.3), clear[:4]
    assert not log.cmds.collision.any()
