"""The native (C++) low-level thrust node against the port (counterpart of
tests/test_low_level_node_cpp.py).

The native node (rt_client/nmpc_low_level_node.{h,cpp}, unchanged) and the
port's `guidance/low_level.py` both implement the reference thrust node's
logic around the solver.  Three tiers, as in the JAX suite:

1. ctypes parity of the sub-steps (x0 packing with the u == 0 guard, yref
   packing, stage-1 extraction with the zero-speed override and the
   carried-thrust memory) against the port's conventions;
2. the live thrust loop: `ll_tick` (v2 frames, `nmpc_rt_solve2`) through
   the port's `usv_low_level` server must give the thrust trajectory of
   the port's `LowLevelController` and of JAX's on the same script;
3. end to end (`slow`, as JAX's): the native two-node cascade
   (`cascade_demo`: guidance node + low-level node + the honest C++ hull)
   against two port servers.
"""

import concurrent.futures
import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance import low_level as jlow_level
from mpc_collisionavoidance_tpu.ocp import builders as jbuilders
from mpc_collisionavoidance_tpu.solver import sqp_rti as jsqp_rti
from mpc_collisionavoidance_tpu_torch.guidance.low_level import (
    BEAM, THRUST_C, LowLevelController, LowLevelMeasurements, LowLevelState)
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.rt.server import RTServer
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import SolverState
from tests.test_torch_rt import _Serving
from tests.torch_guidance import one_torch_thread  # noqa: F401
from tests.torch_native import (LlCmds, LlMeas, LlNode,  # noqa: F401
                                build_dir, low_level_node_library,
                                needs_toolchain, run_demo)

pytestmark = needs_toolchain

# the live thrust loop: the JAX test's solver and 40-tick script
LOOP_N, LOOP_TF, LOOP_ITERS, LOOP_T, GUARD_TICK = 30, 1.0, 8, 40, 20


@pytest.fixture(scope="module")
def ll_lib(build_dir):  # noqa: F811
    return low_level_node_library(build_dir / "libnmpc_low_level_node.so")


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def test_native_substep_parity(ll_lib):
    """Packing and extraction match the port's controller conventions over
    the JAX test's 200 randomized ticks (seed 11), at its tolerances."""
    rng = np.random.default_rng(11)
    node = LlNode()
    ll_lib.ll_init(ctypes.byref(node))
    past = np.zeros(2, np.float32)

    for t in range(200):
        u = 0.0 if t % 13 == 0 else float(rng.uniform(-0.5, 1.5))
        meas = LlMeas(float(rng.uniform(-3, 3)), u,
                      float(rng.uniform(-0.4, 0.4)),
                      float(rng.uniform(-0.8, 0.8)))
        psi_d = float(rng.uniform(-3, 3))
        u_d = 0.0 if t % 7 == 0 else float(rng.uniform(0.0, 1.2))

        x0 = (ctypes.c_float * 8)()
        ll_lib.ll_pack_x0(ctypes.byref(node), ctypes.byref(meas), x0)
        tm = LowLevelMeasurements(
            psi=_f32(meas.psi), u=_f32(0.001 if u == 0.0 else u),
            v=_f32(meas.v), r=_f32(meas.r))
        x0_port = LowLevelController._pack_x0(tm, _f32(past[0]),
                                              _f32(past[1]))
        np.testing.assert_allclose(np.array(x0), x0_port.numpy(), rtol=0,
                                   atol=2e-6,
                                   err_msg=f"x0 mismatch at tick {t}")

        yref = (ctypes.c_float * 10)()
        ll_lib.ll_pack_yref(psi_d, u_d, yref)
        yref_port = np.concatenate([
            [psi_d, np.sin(psi_d), np.cos(psi_d), u_d], np.zeros(6)])
        np.testing.assert_allclose(np.array(yref), yref_port, rtol=0,
                                   atol=2e-6)

        # synthetic stage-1 reply -> extraction
        x1 = rng.uniform(-20, 30, size=8).astype(np.float32)
        cmd = LlCmds()
        ll_lib.ll_extract(ctypes.byref(node), (ctypes.c_float * 8)(*x1),
                          0, ctypes.byref(meas), psi_d, u_d,
                          ctypes.byref(cmd))
        tp, ts = (0.0, 0.0) if u_d == 0.0 else (x1[6], x1[7])
        assert abs(cmd.t_port - tp) < 1e-6 and abs(cmd.t_stbd - ts) < 1e-6
        # the memory carries the raw x1 thrusts even under the override
        assert abs(node.past_t_port - x1[6]) < 1e-6
        assert abs(node.past_t_stbd - x1[7]) < 1e-6
        assert abs(cmd.e_u - (u_d - meas.u)) < 1e-6
        assert abs(cmd.e_psi - (psi_d - meas.psi)) < 1e-6
        assert abs(cmd.tx - (tp + THRUST_C * ts)) < 1e-5
        assert abs(cmd.tz - (tp - THRUST_C * ts) * BEAM / 2) < 1e-5
        past = x1[6:8].copy()


def thrust_script():
    """The JAX test's 40-tick measurement script: raw u (0 at tick 20, the
    guard's tick), the guarded measurements (psi, u, v, r) and the
    commanded psi_d, u_d, all float32."""
    raw_u = [0.0 if t == GUARD_TICK else 0.4 + 0.2 * np.sin(t / 5)
             for t in range(LOOP_T)]
    meas = np.array([[0.3 * np.sin(t / 7),
                      0.001 if raw_u[t] == 0.0 else raw_u[t],
                      0.05 * np.cos(t / 9), 0.1 * np.sin(t / 4)]
                     for t in range(LOOP_T)], np.float32)
    psi_ds = 0.4 * np.cos(np.arange(LOOP_T) / 10).astype(np.float32)
    u_ds = (0.8 + 0.1 * np.sin(np.arange(LOOP_T) / 6)).astype(np.float32)
    return np.asarray(raw_u, np.float32), meas, psi_ds, u_ds


def native_thrust(lib, server, raw_u, meas, psi_ds, u_ds):
    """`ll_tick` over the script through the live `server`: the (T, 2)
    thrusts; the vehicle's lane warm start on the server before each tick
    but the first (whose request seeds the lane), a list of T - 1
    (xbar (N+1, nx), ubar (N, nu)); and the node's carried thrusts before
    each tick (T, 2).  e_u is checked at the guard's tick."""
    c = lib.nmpc_rt_connect(server.path.encode(), 30000)
    assert c, "nmpc_rt_connect failed"
    node, out, carried, warm = LlNode(), [], [], []
    lib.ll_init(ctypes.byref(node))
    try:
        for t in range(len(raw_u)):
            # the server is idle between a reply and the next request
            if t:
                (lane,) = server._lane_of.values()
                st = server._lane_state
                warm.append((st.xbar[:, :, lane].T.clone(),
                             st.ubar[:, :, lane].T.clone()))
            carried.append([node.past_t_port, node.past_t_stbd])
            m = LlMeas(float(meas[t, 0]), float(raw_u[t]),
                       float(meas[t, 2]), float(meas[t, 3]))
            cmd = LlCmds()
            rc = lib.ll_tick(ctypes.byref(node), c, t + 1, ctypes.byref(m),
                             float(psi_ds[t]), float(u_ds[t]),
                             ctypes.byref(cmd))
            assert rc == 0 and cmd.solver_status in (0, 1), (t, rc, cmd)
            if raw_u[t] == 0.0:
                # e_u sees the guarded measurement
                assert abs(cmd.e_u - (u_ds[t] - 0.001)) < 1e-6
            out.append([cmd.t_port, cmd.t_stbd])
    finally:
        lib.nmpc_rt_close(c)
    return np.asarray(out), warm, np.asarray(carried, np.float32)


def controller_ticks(warm, carried, meas, psi_ds, u_ds):
    """The port's `LowLevelController` (the server's schedule) on the CPU
    in float32: every tick of the script at once (a batch of T), each
    from the server's warm start and the node's carried thrusts before
    that tick (tick 0: the controller's own seed).  Returns the (T, 2)
    thrusts and the batch's state."""
    spec = builders.usv_low_level(Tf=LOOP_TF, N=LOOP_N)
    ctrl = LowLevelController(spec, ipm_iters=LOOP_ITERS, device="cpu",
                              dtype=torch.float32)
    seed = ctrl.init_state(LowLevelMeasurements(*meas[0])).solver
    xbar = torch.stack([seed.xbar] + [x for x, _ in warm])
    ubar = torch.stack([seed.ubar] + [u for _, u in warm])
    state = LowLevelState(SolverState(xbar, ubar),
                          *torch.from_numpy(carried).T)
    _, cmds = ctrl.tick(state, LowLevelMeasurements(*meas.T), psi_ds, u_ds)
    return torch.stack([cmds.t_port, cmds.t_stbd], -1).numpy(), state


def jax_controller_ticks(T):
    """JAX's `LowLevelController` tick over a batch of T states
    (`jax.vmap` of its tick), float32, compiled ahead: a function of the
    port's batch state and the script's (T,) measurements and commands
    that returns the (T, 2) thrusts."""
    spec = jbuilders.usv_low_level(Tf=LOOP_TF, N=LOOP_N)
    ctrl = jlow_level.LowLevelController(spec, ipm_iters=LOOP_ITERS)
    nx, nu = spec.model.nx, spec.model.nu

    def sds(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)

    state = jlow_level.LowLevelState(
        jsqp_rti.SolverState(sds(T, LOOP_N + 1, nx), sds(T, LOOP_N, nu)),
        sds(T), sds(T))
    tick = jax.jit(jax.vmap(ctrl.tick)).lower(
        state, jlow_level.LowLevelMeasurements(*(sds(T),) * 4), sds(T),
        sds(T)).compile()

    def run(port_state, meas, psi_ds, u_ds):
        def arr(a):
            return jnp.asarray(np.asarray(a), jnp.float32)

        jstate = jlow_level.LowLevelState(
            jsqp_rti.SolverState(arr(port_state.solver.xbar),
                                 arr(port_state.solver.ubar)),
            arr(port_state.past_t_port), arr(port_state.past_t_stbd))
        _, cmds = tick(jstate, jlow_level.LowLevelMeasurements(
            *(arr(m) for m in meas.T)), arr(psi_ds), arr(u_ds))
        return np.stack([np.asarray(cmds.t_port),
                         np.asarray(cmds.t_stbd)], -1)
    return run


def test_native_tick_through_the_port_server(ll_lib, tmp_path):
    """`ll_tick` through the port's live `usv_low_level` server (the lane
    engine, float32 CPU; fixed centering, mu0 1, 8 iterations, no
    escalation) over the JAX test's 40-tick script: every tick's thrusts
    equal the port's `LowLevelController` tick (float32, the server's
    schedule) and JAX's from the same warm start, carried thrusts and
    measurement, atol 1e-3.  Ticks are compared from the server's own
    warm start because free-running float32 loops are not comparable at
    1e-3: from tick ~25 the thrusts near their box and one float32 ulp in
    one measurement moves JAX's own loop by up to 0.05."""
    raw_u, meas, psi_ds, u_ds = thrust_script()
    # JAX's compile overlaps the served loop
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_ticks = pool.submit(jax_controller_ticks, LOOP_T)
        server = RTServer(str(tmp_path / "ll.sock"), model="usv_low_level",
                          N=LOOP_N, Tf=LOOP_TF, ipm_iters=LOOP_ITERS,
                          max_batch=1, device="cpu")
        with _Serving(server):
            native, warm, carried = native_thrust(ll_lib, server, raw_u,
                                                  meas, psi_ds, u_ds)
        port, state = controller_ticks(warm, carried, meas, psi_ds, u_ds)
        np.testing.assert_allclose(native, port, rtol=0, atol=1e-3)
        np.testing.assert_allclose(
            native, jax_ticks.result()(state, meas, psi_ds, u_ds), rtol=0,
            atol=1e-3)


@pytest.mark.slow
def test_native_cascade_mission_on_the_port(build_dir, tmp_path):  # noqa: F811
    """The native two-node cascade (guidance 20 Hz + low-level 100 Hz +
    the honest C++ hull) drives the challenge-0 buoy line against two port
    servers on the CPU (guidance N=40, Tf=3, 14 iterations; `usv_low_level`
    N=40, Tf=1, 12 iterations; one lane each, for the CPU's sake): exit 0 (cruise speed, every buoy cleared
    > 1.1 m, <= 2% non-converged solves), progress past the line and no
    thrust outside the box."""
    with contextlib.ExitStack() as stack:
        g = stack.enter_context(_Serving(RTServer(
            str(tmp_path / "g.sock"), N=40, Tf=3.0, ipm_iters=14,
            max_batch=1, device="cpu")))
        ll = stack.enter_context(_Serving(RTServer(
            str(tmp_path / "ll.sock"), N=40, Tf=1.0, ipm_iters=12,
            model="usv_low_level", max_batch=1, device="cpu")))
        rc, tail, out = run_demo(
            [build_dir / "cascade_demo", g.address, ll.address, 1400],
            timeout=9000)
    assert rc == 0, out
    assert "progressed 1" in tail and "thrust_violations 0" in tail, tail
