"""The native (C++) flagship guidance node against the port (counterpart of
tests/test_guidance_node_cpp.py).

The native node (rt_client/nmpc_guidance_node.{h,cpp}, unchanged) and the
port's guidance modules both implement the reference node's logic around
the solver.  Two tiers, as in the JAX suite:

1. ctypes parity: the obstacle intake, the waypoint manager with the
   crab-angle packing and the command extraction of the native node, of
   the port (`guidance/{obstacles,waypoints,controller}.py`,
   `utils/angles.py`, float32 CPU tensors) and of the JAX package meet on
   one scripted 400-tick trajectory, at the JAX test's tolerances;
2. end to end (`slow`, as JAX's): the two-leg avoidance mission of
   `guidance_node_demo` against the port's live `RTServer` on the CPU,
   over a Unix socket and over TCP loopback.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.guidance import obstacles as jobs
from mpc_collisionavoidance_tpu.guidance.controller import (
    GuidanceController as JaxController)
from mpc_collisionavoidance_tpu.guidance.controller import (
    Measurements as JaxMeasurements)
from mpc_collisionavoidance_tpu.guidance.waypoints import (
    mission_init as jmission_init)
from mpc_collisionavoidance_tpu.guidance.waypoints import (
    waypoint_manager as jwaypoint_manager)
from mpc_collisionavoidance_tpu.utils.angles import wrap_once as jwrap_once
from mpc_collisionavoidance_tpu_torch.guidance import obstacles as obs
from mpc_collisionavoidance_tpu_torch.guidance.controller import (
    GuidanceController, Measurements)
from mpc_collisionavoidance_tpu_torch.guidance.waypoints import (
    mission_init, waypoint_manager)
from mpc_collisionavoidance_tpu_torch.rt.server import RTServer
from mpc_collisionavoidance_tpu_torch.utils.angles import wrap_once
from tests.test_torch_rt import _Serving
from tests.torch_guidance import one_torch_thread  # noqa: F401
from tests.torch_native import (GnCmds, GnMeas, build_dir,  # noqa: F401
                                guidance_node_library, needs_toolchain,
                                run_demo)

pytestmark = needs_toolchain

# the JAX test's tolerances (tests/test_guidance_node_cpp.py:163-175)
TOL = dict(x0=2e-5, p_obs=2e-4, r_obs=2e-5, ye=2e-4, u_d=1e-6, target=1e-6,
           psi_d=2e-5, r_d=1e-6)
CAP = 16   # the intake's fixed field capacity (JAX's top_k needs >= 8)


@pytest.fixture(scope="module")
def lib(build_dir):  # noqa: F811
    return guidance_node_library(build_dir)


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _close(what, got, want, t):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=TOL[what], err_msg=f"{what} at tick {t}")


def test_native_logic_matches_port_and_jax(lib):
    """The JAX test's scripted 400-tick two-leg trajectory (seed 42: a
    moving vehicle, random obstacle fields of 0-13 bodies, u on the zero
    guard every 17th tick, synthetic solver replies) through the native
    node, the port and the JAX package: packed x0, obstacle slots, frame
    telemetry and extracted commands of the node against the port's, and
    the port's against JAX's, at the JAX test's tolerances."""
    rng = np.random.default_rng(42)
    wps = np.array([[4.0, -5.0], [4.0, 25.0], [20.0, 25.0]], np.float32)
    psi0 = 0.3

    wp_flat = wps.reshape(-1).astype(np.float32)
    node = lib.gn_create(
        wp_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(wps), psi0)
    assert node
    wps_t = torch.from_numpy(wps)
    mission = mission_init(wps_t, len(wps), _f32(psi0))
    # JAX's functions jitted (the comparison's cost is otherwise JAX's
    # op-by-op dispatch)
    jintake = jax.jit(jobs.intake)
    jmanager = jax.jit(jwaypoint_manager, static_argnums=2)
    jpack = jax.jit(JaxController._pack_x0)
    jwrap = jax.jit(jwrap_once)
    jmission = jmission_init(wps, len(wps), jnp.float32(psi0))

    T = 400
    s = np.linspace(0.0, 52.0, T)
    path = np.where(
        (s < 30.0)[:, None],
        np.stack([4.0 + 0.8 * np.sin(s / 3.0), -5.0 + s], axis=1),
        np.stack([4.0 + (s - 30.0), 25.0 + 0.2 * np.cos(s)], axis=1))
    psis = (psi0 + 0.8 * np.sin(s / 5.0)).astype(np.float32)

    try:
        for t in range(T):
            u = float(rng.uniform(0.0, 1.2)) if t % 17 else 0.0
            v = float(rng.uniform(-0.3, 0.3))
            nedx, nedy, psi = (float(path[t, 0]), float(path[t, 1]),
                               float(psis[t]))
            meas = GnMeas(u, v, nedx, nedy, psi)
            pose = tuple(_f32(a) for a in (nedx, nedy, psi))

            # obstacle intake on a random body-frame field (n > 8 too)
            n_obs = int(rng.integers(0, 14))
            body = rng.uniform(-20, 20, size=(max(n_obs, 1), 2)).astype(
                np.float32)
            radii = rng.uniform(0.2, 2.0, size=max(n_obs, 1)).astype(
                np.float32)
            xyr = np.concatenate([body, radii[:, None]], axis=1)[:n_obs]
            flat = np.ascontiguousarray(xyr.reshape(-1), np.float32)
            lib.gn_obstacles(node, flat.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)), n_obs, ctypes.byref(meas))

            # the fixed-capacity masked field: an empty one leaves every
            # slot on the sentinel
            body_pad = np.zeros((CAP, 2), np.float32)
            radii_pad = np.zeros(CAP, np.float32)
            body_pad[:n_obs] = body[:n_obs]
            radii_pad[:n_obs] = radii[:n_obs]
            valid = np.arange(CAP) < n_obs
            slots = obs.intake(torch.from_numpy(body_pad),
                               torch.from_numpy(radii_pad),
                               torch.from_numpy(valid), *pose)
            jslots = jintake(jnp.asarray(body_pad), jnp.asarray(radii_pad),
                             jnp.asarray(valid), jnp.float32(nedx),
                             jnp.float32(nedy), jnp.float32(psi))

            # waypoint tick + packing
            x0_c = (ctypes.c_float * 8)()
            p_c = (ctypes.c_float * 16)()
            r_c = (ctypes.c_float * 8)()
            cmd = GnCmds()
            lib.gn_pack(node, ctypes.byref(meas), x0_c, p_c, r_c,
                        ctypes.byref(cmd))

            mission, frame = waypoint_manager(mission, wps_t, len(wps),
                                              pose[0], pose[1])
            jmission, jframe = jmanager(jmission, wps, len(wps),
                                        jnp.float32(nedx), jnp.float32(nedy))
            x0 = GuidanceController._pack_x0(
                Measurements(_f32(u), _f32(v), *pose), mission.past_psied,
                frame.ye, frame.ak)
            jx0 = jpack(
                JaxMeasurements(jnp.float32(u), jnp.float32(v),
                                jnp.float32(nedx), jnp.float32(nedy),
                                jnp.float32(psi)),
                jmission.past_psied, jframe.ye, jframe.ak)

            for what, native, port, jax_ in (
                    ("x0", np.array(x0_c), x0, jx0),
                    ("p_obs", np.array(p_c), slots.p_obs, jslots.p_obs),
                    ("r_obs", np.array(r_c), slots.r_obs, jslots.r_obs),
                    ("ye", cmd.ye, frame.ye, jframe.ye),
                    ("u_d", cmd.u_d, frame.u_d, jframe.u_d),
                    ("target", np.array(cmd.target), frame.target,
                     jframe.target)):
                _close(what, native, port, t)
                _close(what, port, jax_, t)
            assert cmd.active == int(bool(frame.u_d > 0)), t
            assert bool(mission.active) == bool(jmission.active), t

            # synthetic solver reply -> command extraction
            x1 = rng.uniform(-1, 1, size=8).astype(np.float32)
            u0 = float(rng.uniform(-0.5, 0.5))
            lib.gn_extract(node, (ctypes.c_float * 8)(*x1), u0,
                           ctypes.byref(cmd))
            if bool(mission.active):
                psi_d = wrap_once(_f32(x1[4]) + frame.ak)
                jpsi_d = jwrap(jnp.float32(x1[4]) + jframe.ak)
                _close("psi_d", cmd.psi_d, psi_d, t)
                _close("psi_d", psi_d, jpsi_d, t)
                _close("r_d", cmd.r_d, u0, t)
                # carried command memory (controller.tick)
                mission = mission._replace(past_psied=_f32(x1[4]))
                jmission = jmission._replace(past_psied=jnp.float32(x1[4]))
    finally:
        lib.gn_destroy(node)
    # the scripted track exercised both transitions
    assert not bool(mission.active), "mission never finished"


@pytest.mark.slow
@pytest.mark.parametrize("transport", ["uds", "tcp"])
def test_native_node_full_mission_on_the_port(build_dir, tmp_path,  # noqa: F811
                                              transport):
    """`guidance_node_demo <addr> 2500` against the port's live server
    (N=100, Tf=5, 14 IPM iterations, the lane engine on the CPU at one
    lane: a CPU tick of 128 lanes nears the node's 5 s timeout), over a
    Unix socket and over TCP loopback (a free port, `bound_port`): exit 0
    (every buoy cleared > 1.3 m, <= 2% non-converged ticks), the segment
    switch and the final capture on its last line."""
    address = (str(tmp_path / "nmpc.sock") if transport == "uds"
               else "127.0.0.1:0")
    server = RTServer(address, N=100, Tf=5.0, ipm_iters=14, max_batch=1,
                      device="cpu")
    with _Serving(server) as srv:
        if transport == "tcp":
            assert srv.server.bound_port > 0
        rc, tail, out = run_demo(
            [build_dir / "guidance_node_demo", srv.address, 2500],
            timeout=3000)
    assert rc == 0, out
    assert "switched 1" in tail and "done 1" in tail, tail
