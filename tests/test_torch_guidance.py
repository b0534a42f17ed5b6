"""The port's guidance building blocks — the angle wraps, the LiDAR
perception and top-8 intake, the waypoint manager, `LaneSolverAdapter`
and `GuidanceController.tick` — vs the JAX package's, float64 on the CPU
(the JAX side vmapped where the port takes a batch axis)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance import GuidanceController as JaxCtrl
from mpc_collisionavoidance_tpu.guidance import Measurements as JaxMeas
from mpc_collisionavoidance_tpu.guidance import mission_init as jax_init
from mpc_collisionavoidance_tpu.guidance import obstacles as jobs
from mpc_collisionavoidance_tpu.guidance import waypoint_manager as jax_wpm
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.ops import integrators as jintegrators
from mpc_collisionavoidance_tpu.solver.batch import LaneRTISolver as JaxLane
from mpc_collisionavoidance_tpu.solver.batch import (
    LaneSolverAdapter as JaxAdapter)
from mpc_collisionavoidance_tpu.utils import angles as jangles
from mpc_collisionavoidance_tpu_torch import interop
from mpc_collisionavoidance_tpu_torch.config import production_engine
from mpc_collisionavoidance_tpu_torch.guidance import (GuidanceController,
                                                       mission_init,
                                                       waypoint_manager)
from mpc_collisionavoidance_tpu_torch.guidance import obstacles as obs
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.solver.batch import LaneSolverAdapter
from mpc_collisionavoidance_tpu_torch.utils import angles
from tests.torch_guidance import jax_production_kw, one_torch_thread  # noqa: F401

F64 = torch.float64
EXACT = 1e-12
B = 64


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# angles

def test_wrap_once_and_ssa_match_jax():
    a = np.random.default_rng(0).uniform(-3 * np.pi, 3 * np.pi, 4096)
    a[:4] = (np.pi, -np.pi, 0.0, 2 * np.pi)
    for fn, jfn in ((angles.wrap_once, jangles.wrap_once),
                    (angles.ssa, jangles.ssa)):
        got = fn(_t(a))
        assert got.dtype == F64 and got.shape == a.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(a))),
                                   rtol=0, atol=EXACT)
    # a 0-d float32 stays 0-d float32
    assert angles.wrap_once(torch.tensor(4.0)).shape == ()
    assert angles.wrap_once(torch.tensor(4.0)).dtype == torch.float32


# ---------------------------------------------------------------------------
# perception

def _fields(seed):
    """B random worlds at full capacity: vehicle poses, (B, M, 3) fields
    with masks.  Every kind a tick meets: nothing visible, fewer than 8,
    more than 8 (truncation), rows beyond the 100 m radius, a vehicle
    inside an inflated radius (collision), and exact ties of the sort
    key: mirrored buoys around a vehicle at the origin heading 0, and
    every invisible row (key FAR)."""
    rng = np.random.default_rng(seed)
    M = scenarios.FIELD_CAPACITY
    field = np.zeros((B, M, 3))
    valid = np.zeros((B, M), bool)
    pose = np.zeros((B, 3))
    for b in range(B):
        kind = b % 4
        n = [0, 5, 20, 24][kind]
        field[b, :n, :2] = rng.uniform(-30, 30, (n, 2))
        field[b, :n, 2] = rng.choice([0.1, 0.3, 1.0], n)
        valid[b, :n] = True
        if kind == 2:
            field[b, 3, :2] = (150.0, -20.0)          # beyond 100 m
            pose[b] = rng.uniform(-5, 5, 3)
        elif kind == 3:
            # mirrored pairs about the x axis: equal keys at psi = 0
            field[b, 12:24] = field[b, :12] * np.array([1.0, -1.0, 1.0])
            field[b, 0] = (0.5, 0.2, 1.0)             # collision
        else:
            pose[b] = rng.uniform(-5, 5, 3)
    return field, valid, pose


def _jax_perceive(field, valid, pose, shared=False):
    fn = jax.vmap(jobs.perceive, in_axes=(None if shared else 0,
                                          None if shared else 0, 0, 0, 0))
    return fn(jnp.asarray(field), jnp.asarray(valid), *map(jnp.asarray,
                                                            pose.T))


def _assert_slots(got, want):
    np.testing.assert_allclose(got.p_obs.numpy(), np.asarray(want.p_obs),
                               rtol=0, atol=EXACT)
    np.testing.assert_allclose(got.r_obs.numpy(), np.asarray(want.r_obs),
                               rtol=0, atol=EXACT)
    np.testing.assert_array_equal(got.collision.numpy(),
                                  np.asarray(want.collision))
    np.testing.assert_array_equal(got.n_visible.numpy(),
                                  np.asarray(want.n_visible))
    assert got.n_visible.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_perceive_matches_jax_on_random_fields(seed):
    field, valid, pose = _fields(seed)
    got = obs.perceive(_t(field), _t(valid), *map(_t, pose.T))
    want = _jax_perceive(field, valid, pose)
    _assert_slots(got, want)
    # the fields reach every case the docstring of _fields names
    n_vis = got.n_visible.numpy()
    assert (n_vis == 0).any() and ((n_vis > 0) & (n_vis < 8)).any()
    assert (n_vis > 8).any() and got.collision.any()


def test_lidar_scan_and_intake_match_jax():
    field, valid, pose = _fields(2)
    body, radius, vis = obs.lidar_scan(_t(field), _t(valid),
                                       *map(_t, pose.T))
    jbody, jradius, jvis = jax.vmap(jobs.lidar_scan)(
        jnp.asarray(field), jnp.asarray(valid), *map(jnp.asarray, pose.T))
    np.testing.assert_allclose(body.numpy(), np.asarray(jbody), rtol=0,
                               atol=EXACT)
    np.testing.assert_array_equal(radius.numpy(), np.asarray(jradius))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    got = obs.intake(body, radius, vis, *map(_t, pose.T))
    want = jax.vmap(jobs.intake)(jbody, jradius, jvis,
                                 *map(jnp.asarray, pose.T))
    _assert_slots(got, want)


def test_intake_tie_order_is_jax_top_k_order():
    """Equal sort keys keep index order, as jax.lax.top_k's: two mirrored
    buoys (equal surface distance) at every pair of rows, more of them
    than slots, so that the order decides which are kept and in which
    slot each lands."""
    M = scenarios.FIELD_CAPACITY
    field = np.zeros((M, 3))
    ys = np.arange(1, 7) * 1.5
    for i, y in enumerate(ys):                        # rows 2i, 2i+1 tie
        field[2 * i] = (3.0, y, 0.3)
        field[2 * i + 1] = (3.0, -y, 0.3)
    valid = np.arange(M) < 12
    zero = torch.zeros((), dtype=F64)
    got = obs.perceive(_t(field), _t(valid), zero, zero, zero)
    want = jobs.perceive(jnp.asarray(field), jnp.asarray(valid), 0.0, 0.0,
                         0.0)
    _assert_slots(got, want)
    # slot order: (3, 1.5), (3, -1.5), (3, 3), (3, -3), ...
    np.testing.assert_array_equal(got.p_obs.numpy()[1:16:2],
                                  [1.5, -1.5, 3.0, -3.0, 4.5, -4.5, 6.0, -6.0])


def test_perceive_shared_field_matches_per_vehicle_field():
    field, valid, pose = _fields(3)
    f0, v0 = field[2], valid[2]
    got = obs.perceive(_t(f0), _t(v0), *map(_t, pose.T))
    tiled = obs.perceive(_t(np.broadcast_to(f0, field.shape).copy()),
                         _t(np.broadcast_to(v0, valid.shape).copy()),
                         *map(_t, pose.T))
    _assert_slots(got, _jax_perceive(f0, v0, pose, shared=True))
    for a, b in zip(got, tiled):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# waypoint manager

def _wp_tables(seed, max_wp=6):
    """B random polylines, n_wp from 1 to max_wp (padding rows random),
    and start poses near the first waypoint."""
    rng = np.random.default_rng(seed)
    wps = rng.uniform(-20, 20, (B, max_wp, 2))
    steps = rng.uniform(2.0, 4.0, (B, max_wp - 1, 1)) * np.stack(
        [np.cos(a := rng.uniform(-np.pi, np.pi, (B, max_wp - 1))),
         np.sin(a)], -1)
    wps[:, 1:] = wps[:, :1] + np.cumsum(steps, axis=1)
    n_wp = rng.integers(1, max_wp + 1, B)
    n_wp[:4] = (1, 2, max_wp, 2)
    psi = rng.uniform(-np.pi, np.pi, B)
    return wps, n_wp, psi


def test_waypoint_manager_matches_jax_over_whole_missions():
    """A batch of missions with different n_wp (1 = never active) driven
    toward their current target with noise, long enough that every
    mission advances, finishes, and keeps ticking after it finished (the
    segment gathers then read the table's last rows)."""
    wps, n_wp, psi = _wp_tables(0)
    rng = np.random.default_rng(1)
    jst = jax.vmap(jax_init, in_axes=(0, 0, 0, None))(
        jnp.asarray(wps), jnp.asarray(n_wp), jnp.asarray(psi), jnp.float64)
    tst = mission_init(_t(wps), _t(n_wp), _t(psi))
    assert tst.k.dtype == torch.int32 and tst.active.dtype == torch.bool
    pos = wps[:, 0].copy()
    step = jax.jit(jax.vmap(jax_wpm))
    finished_ticks = 0
    for _ in range(60):
        jst, jfr = step(jst, jnp.asarray(wps), jnp.asarray(n_wp),
                        jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]))
        tst, tfr = waypoint_manager(tst, _t(wps), _t(n_wp), _t(pos[:, 0]),
                                    _t(pos[:, 1]))
        np.testing.assert_array_equal(tst.k.numpy(), np.asarray(jst.k))
        np.testing.assert_array_equal(tst.active.numpy(),
                                      np.asarray(jst.active))
        np.testing.assert_array_equal(tfr.advanced.numpy(),
                                      np.asarray(jfr.advanced))
        np.testing.assert_allclose(tst.past_psied.numpy(),
                                   np.asarray(jst.past_psied), rtol=0,
                                   atol=EXACT)
        for f in ("x1", "y1", "ak", "ye", "target", "u_d"):
            np.testing.assert_allclose(getattr(tfr, f).numpy(),
                                       np.asarray(getattr(jfr, f)), rtol=0,
                                       atol=EXACT, err_msg=f)
        # move 1.2 m toward the target, with noise
        d = tfr.target.numpy() - pos
        pos = pos + 1.2 * d / np.maximum(np.linalg.norm(d, axis=1), 1e-9)[
            :, None] + rng.normal(0, 0.05, pos.shape)
        finished_ticks += int((~tst.active.numpy() & (n_wp >= 2)).sum())
    k = tst.k.numpy()
    assert (k == np.maximum(n_wp - 1, 1)).all()       # every one advanced
    assert not tst.active.numpy().any() and finished_ticks > 100


def _tick_both(st, jst, wps, n_wp, x, y):
    st, fr = waypoint_manager(st, _t(wps), n_wp, torch.tensor(x, dtype=F64),
                              torch.tensor(y, dtype=F64))
    jst, jfr = jax_wpm(jst, jnp.asarray(wps), n_wp, x, y)
    assert int(st.k) == int(jst.k)
    assert bool(st.active) == bool(jst.active)
    for f in ("x1", "y1", "ak", "ye", "target", "u_d"):
        np.testing.assert_allclose(getattr(fr, f).numpy(),
                                   np.asarray(getattr(jfr, f)), rtol=0,
                                   atol=EXACT, err_msg=f)
    return st, jst, fr


def test_finished_mission_keeps_ticking_past_the_table():
    """A two-waypoint table at full capacity (MAX_WP = n_wp = 2): after
    the finish, ticks read the last segment again and stay finite.  Then
    a count past the table (n_wp = 4 on 2 rows): k climbs past the last
    row and the segment gathers clamp to it, as jnp's gather clips (a
    torch gather past the table would raise)."""
    wps = np.array([[0.0, 0.0], [5.0, 0.0]])
    st = mission_init(_t(wps), 2, torch.tensor(0.0, dtype=F64))
    jst = jax_init(wps, 2, 0.0, jnp.float64)
    for x in (3.0, 4.5, 4.7, 9.0, 20.0):
        st, jst, fr = _tick_both(st, jst, wps, 2, x, 0.3)
        assert int(st.k) == 1
    assert not bool(st.active) and float(fr.u_d) == 0.0
    st = mission_init(_t(wps), 4, torch.tensor(0.0, dtype=F64))
    jst = jax_init(wps, 4, 0.0, jnp.float64)
    for _ in range(4):
        st, jst, fr = _tick_both(st, jst, wps, 4, 5.0, 0.0)
    assert int(st.k) == 3 and not bool(st.active)


# ---------------------------------------------------------------------------
# LaneSolverAdapter and GuidanceController

N, TF = 25, 2.0


def _adapters():
    jspec, spec = (jbuilders.usv_guidance_ca1(Tf=TF, N=N),
                   builders.usv_guidance_ca1(Tf=TF, N=N))
    return (JaxAdapter(JaxLane(jspec, **jax_production_kw())),
            LaneSolverAdapter(production_engine().build(
                spec, device="cpu", dtype=F64)))


def test_lane_solver_adapter_matches_jax():
    """Ten warm-started flagship ticks, x0 <- x1, on the production
    schedule at lane width 1."""
    jad, tad = _adapters()
    sc = scenarios.guidance_ca1_default()
    x = sc.x0.copy()
    x[2] += 0.3
    jst = jad.init_state(jnp.asarray(x), dtype=jnp.float64)
    tst = tad.init_state(x)
    step = jax.jit(jad.step_fn)
    for _ in range(10):
        jst, jout = step(jst, jnp.asarray(x), jnp.asarray(sc.params),
                         jnp.asarray(sc.lh))
        tst, tout = tad.step_fn(tst, x, sc.params, sc.lh)
        assert tout.u0.shape == (1,) and tout.x1.shape == (8,)
        assert tout.status.shape == () and tout.gap.shape == ()
        for f in ("u0", "x1", "gap"):
            np.testing.assert_allclose(getattr(tout, f).numpy(),
                                       np.asarray(getattr(jout, f)),
                                       rtol=0, atol=5e-6, err_msg=f)
        assert int(tout.status) == int(jout.status)
        x = np.asarray(jout.x1)
    with pytest.raises(ValueError, match="per-stage"):
        tad.step_fn(tst, x, sc.params, sc.lh,
                    yref=np.zeros((N, tad.spec.cost.ny)))


def _jax_mid_mission(jctrl, wps, n_wp, field, valid, ticks):
    """The JAX controller driven `ticks` ticks through the mission plant
    (sim/mission.py's); returns its state and measurement then."""
    spec = jctrl.spec
    plant = jintegrators.make_discrete_dynamics(spec.model.f, spec.dt,
                                                num_steps=4)
    meas = JaxMeas(*(jnp.asarray(v, jnp.float64)
                     for v in (0.7, 0.0, 0.0, 0.0, 0.0)))
    st = jctrl.init_state(meas, wps, n_wp, dtype=jnp.float64)
    tick = jax.jit(jctrl.tick)

    @jax.jit
    def advance(cmds):
        x = plant(cmds.x0, cmds.r_d[None], jnp.zeros((spec.model.np_,)))
        return JaxMeas(u=cmds.u_d, v=x[1], nedx=x[5], nedy=x[6], psi=x[7])

    for _ in range(ticks):
        st, cmds = tick(st, meas, wps, n_wp, field, valid)
        meas = advance(cmds)
    return st, meas, tick, advance


CTRL_CASES = {
    # case: (solver, atol of the commands)
    "rti": ("rti", 1e-8),
    "adapter": ("adapter", 5e-6),
}


@pytest.mark.parametrize("case", sorted(CTRL_CASES))
def test_controller_tick_matches_jax_from_mid_mission(case):
    """From one JAX mid-mission state on the autonav course (after two
    segment switches, 8 slots saturated), 20 ticks of both controllers on
    the same measurements: commands at the stated tolerance, identical
    status, mission and collision flags."""
    kind, atol = CTRL_CASES[case]
    wps, n_wp, field, valid = scenarios.autonav_mission()
    wps_j, field_j, valid_j = (jnp.asarray(a) for a in (wps, field, valid))
    if kind == "rti":
        jctrl = JaxCtrl(jbuilders.usv_guidance_ca1(Tf=TF, N=N), ipm_iters=12)
        ctrl = GuidanceController(builders.usv_guidance_ca1(Tf=TF, N=N),
                                  ipm_iters=12, device="cpu", dtype=F64)
    else:
        jad, tad = _adapters()
        jctrl = JaxCtrl(jad.spec, solver=jad)
        ctrl = GuidanceController(tad.spec, solver=tad)
    jst, meas, tick, advance = _jax_mid_mission(jctrl, wps_j, n_wp, field_j,
                                                valid_j, ticks=230)
    assert int(jst.mission.k) >= 2
    m = jst.mission
    solver = (interop.solver_state_from_numpy(
        *map(np.asarray, jst.solver), device="cpu", dtype=F64)
        if kind == "rti" else interop.lane_state_from_numpy(
            *map(np.asarray, jst.solver), device="cpu", dtype=F64))
    st = interop.guidance_state_from_numpy(
        tuple(map(np.asarray, m)), solver, np.asarray(jst.psi_d_hold),
        np.asarray(jst.r_d_hold), device="cpu", dtype=F64)
    for _ in range(20):
        jst, jcmds = tick(jst, meas, wps_j, n_wp, field_j, valid_j)
        st, cmds = ctrl.tick(st, tuple(np.asarray(v) for v in meas), wps,
                             n_wp, field, valid)
        for f in ("psi_d", "r_d", "u_d", "ye", "target", "ak", "x0"):
            np.testing.assert_allclose(getattr(cmds, f).numpy(),
                                       np.asarray(getattr(jcmds, f)),
                                       rtol=0, atol=atol, err_msg=f)
        for f in ("solver_status", "active", "collision"):
            assert bool((getattr(cmds, f) == torch.as_tensor(
                np.asarray(getattr(jcmds, f)))).all()), f
        np.testing.assert_array_equal(st.mission.k.numpy(),
                                      np.asarray(jst.mission.k))
        meas = advance(jcmds)


def test_entry_points_default_to_the_card():
    """Built without `device`, the controller asks for the card: on a host
    without one it raises (no path falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    spec = builders.usv_guidance_ca1(Tf=TF, N=N)
    with pytest.raises(ValueError, match="no CUDA device"):
        GuidanceController(spec)
    with pytest.raises(ValueError, match="usv_guidance_ca1"):
        GuidanceController(builders.usv_low_level(N=10), device="cpu")
