"""The port's fleet mission engine (`sim/fleet.py`) vs the JAX package's,
and vs the port's own batched missions, float64 on the CPU; the JAX
suite's challenge-0 fleet property on the port (`slow`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance import Measurements as JaxMeas
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.sim.fleet import FleetMissionEngine as JaxFleet
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import (SolverConfig,
                                                     production_engine)
from mpc_collisionavoidance_tpu_torch.guidance import GuidanceController
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import mission, scenarios
from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetMissionEngine
from tests.torch_guidance import jax_production_kw, one_torch_thread  # noqa: F401

F64 = torch.float64
B, T = 3, 120


def _fleet_inputs(B):
    """tests/test_fleet.py::_fleet_inputs: the challenge-0 course, starts
    spread across the path."""
    field, valid = scenarios.challenge0_field()
    wps = np.broadcast_to(np.array([[4.0, -5.0], [4.0, 25.0]]),
                          (B, 2, 2)).copy()
    n_wp = np.full((B,), 2)
    meas0 = (np.full(B, 0.7), np.zeros(B), np.linspace(-0.5, 0.5, B),
             np.zeros(B), np.zeros(B))
    return field, valid, wps, n_wp, meas0


SCHEDULES = {
    # schedule: (JAX LaneRTISolver keywords, the port's SolverConfig)
    "fixed": (dict(ipm_iters=12), SolverConfig(ipm_iters=12)),
    "production": (jax_production_kw(), production_engine()),
}


def _assert_logs(got, want, atol):
    for f in ("pos", "ye", "psi_d"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f)
    for f in ("active", "collision", "status"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_fleet_matches_jax(schedule):
    """B=3, N=25, 120 ticks: track, cross-track error and heading command
    at 1e-6, identical status, activity and collision flags; then the
    JAX fleet's final state carried into the port (interop) ticks on as
    JAX's does."""
    jkw, config = SCHEDULES[schedule]
    field, valid, wps, n_wp, meas0 = _fleet_inputs(B)
    jfleet = JaxFleet(jbuilders.usv_guidance_ca1(Tf=2.0, N=25), **jkw)
    want = jax.jit(lambda m: jfleet.run(m, wps, n_wp, field, valid,
                                        n_steps=T, dtype=jnp.float64))(
        JaxMeas(*map(jnp.asarray, meas0)))
    fleet = FleetMissionEngine(builders.usv_guidance_ca1(Tf=2.0, N=25),
                               config, device="cpu", dtype=F64)
    got = fleet.run(meas0, wps, n_wp, field, valid, n_steps=T)
    assert got.pos.shape == (T, B, 2) and got.status.dtype == torch.int32
    _assert_logs(got, want, 1e-6)
    np.testing.assert_array_equal(got.final.mission_k.numpy(),
                                  np.asarray(want.final.mission_k))

    # resume JAX's final state in the port for 5 ticks
    jf = want.final
    st = interop.fleet_state_from_numpy(
        *(np.asarray(a) for a in (jf.mission_k, jf.past_psied, jf.active,
                                  jf.solver.xbar, jf.solver.ubar)),
        tuple(np.asarray(m) for m in jf.meas), device="cpu", dtype=F64)
    args = (torch.as_tensor(wps), torch.as_tensor(n_wp, dtype=torch.int32),
            torch.as_tensor(field), torch.as_tensor(valid))
    jtick = jax.jit(lambda s: jfleet.tick(s, jnp.asarray(wps),
                                          jnp.asarray(n_wp),
                                          jnp.asarray(field),
                                          jnp.asarray(valid)))
    for _ in range(5):
        jf, jlog = jtick(jf)
        st, log = fleet.tick(st, *args)
        for g, w in zip(log, jlog):
            np.testing.assert_allclose(g.numpy().astype(float),
                                       np.asarray(w).astype(float), rtol=0,
                                       atol=1e-6)


def test_fleet_matches_batched_missions():
    """The lane-engine fleet against the port's batched per-instance
    missions (RTISolver, batch axes) on the same course, 40 ticks (the
    per-instance engine's CPU tick is the slow side): the port's own
    tests/test_fleet.py::test_fleet_matches_vmapped_missions."""
    spec = builders.usv_guidance_ca1(Tf=2.0, N=25)
    field, valid, wps, n_wp, meas0 = _fleet_inputs(B)
    fleet = FleetMissionEngine(spec, ipm_iters=12, device="cpu", dtype=F64)
    log_f = fleet.run(meas0, wps, n_wp, field, valid, n_steps=40)
    ctrl = GuidanceController(spec, ipm_iters=12, device="cpu", dtype=F64)
    log_m = mission.run_mission(ctrl, meas0, wps[0], 2, field, valid,
                                n_steps=40)
    np.testing.assert_allclose(log_f.pos.numpy(), log_m.pos.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(log_f.ye.numpy(), log_m.cmds.ye.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(log_f.psi_d.numpy(),
                               log_m.cmds.psi_d.numpy(), rtol=0, atol=1e-6)


def test_per_vehicle_fields_match_a_shared_field():
    """A (B, M, 3) field that repeats the shared (M, 3) one gives the same
    fleet; different per-vehicle fields give different tracks."""
    spec = builders.usv_guidance_ca1(Tf=2.0, N=20)
    field, valid, wps, n_wp, meas0 = _fleet_inputs(B)
    fleet = FleetMissionEngine(spec, ipm_iters=10, device="cpu", dtype=F64)
    shared = fleet.run(meas0, wps, n_wp, field, valid, n_steps=25)
    fields = np.broadcast_to(field, (B,) + field.shape).copy()
    valids = np.broadcast_to(valid, (B,) + valid.shape).copy()
    tiled = fleet.run(meas0, wps, n_wp, fields, valids, n_steps=25)
    for f in ("pos", "ye", "psi_d", "active", "collision", "status"):
        np.testing.assert_allclose(
            getattr(tiled, f).numpy().astype(float),
            getattr(shared, f).numpy().astype(float), rtol=0, atol=1e-12,
            err_msg=f)
    valids[1] = False                                 # no buoys for one
    other = fleet.run(meas0, wps, n_wp, fields, valids, n_steps=25)
    np.testing.assert_allclose(other.pos.numpy()[:, [0, 2]],
                               shared.pos.numpy()[:, [0, 2]], rtol=0,
                               atol=1e-12)
    assert not np.allclose(other.pos.numpy()[:, 1], shared.pos.numpy()[:, 1])


def test_fleet_builds_on_the_card_by_default():
    """Without `device` the fleet asks for the card: on a host without
    one it raises; a config and solver keywords together raise too."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    spec = builders.usv_guidance_ca1(Tf=2.0, N=20)
    with pytest.raises(ValueError, match="no CUDA device"):
        FleetMissionEngine(spec)
    with pytest.raises(ValueError, match="either"):
        FleetMissionEngine(spec, production_engine(), ipm_iters=3,
                           device="cpu")


@pytest.mark.slow
def test_fleet_completes_challenge0():
    """tests/test_fleet.py::test_fleet_completes_challenge0 on the port:
    B=4, N=40, 1200 ticks, float32 as JAX's; every vehicle finishes near
    the last waypoint and none enters a buoy."""
    Bc = 4
    field, valid, wps, n_wp, meas0 = _fleet_inputs(Bc)
    fleet = FleetMissionEngine(builders.usv_guidance_ca1(Tf=3.0, N=40),
                               ipm_iters=10, device="cpu",
                               dtype=torch.float32)
    log = fleet.run(meas0, wps, n_wp, field, valid, n_steps=1200)
    pos, active = log.pos.numpy(), log.active.numpy()
    assert np.all(np.isfinite(pos))
    assert not np.any(active[-1]), active[-1]
    for b in range(Bc):
        end = pos[np.argmax(~active[:, b]), b]
        assert np.hypot(end[0] - 4.0, end[1] - 25.0) < 1.3, (b, end)
    assert not log.collision.any()
