"""The port's real-time serving layer (`rt/protocol.py`, `rt/server.py`) vs
the JAX package's: byte-identical frames; the JAX server's scenarios
(tests/test_rt.py) on the port's server on the CPU; one wire closed loop
through both servers; and the unchanged C++ client library driving the
port's server."""

import asyncio
import contextlib
import ctypes
import math
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu.rt import protocol as jprotocol
from mpc_collisionavoidance_tpu_torch.rt import protocol
from mpc_collisionavoidance_tpu_torch.rt.server import (STATUS_OVER_CAPACITY,
                                                        RTServer)
from mpc_collisionavoidance_tpu_torch.sim import scenarios

REPO = Path(__file__).resolve().parent.parent
AK = math.pi / 2
FLAGSHIP_X0 = (0.7, 0.0, -4.0, -AK, -AK, 0.0, 0.0, 0.0)
SENTINEL_P = (100.0,) * 16
NO_R = (0.0,) * 8
HULL = scenarios.pf_ca_default()


class _Serving:
    """Run an RT server (the port's or the JAX package's) on a background
    asyncio loop for a test."""

    def __init__(self, server):
        self.server = server
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self.server.start())
        self._loop.run_forever()

    @property
    def address(self) -> str:
        port = self.server.bound_port
        if port is not None:
            return f"{self.server.parse_tcp(self.server.path)[0]}:{port}"
        return self.server.path

    def __enter__(self):
        self.server.warmup()
        self._thread.start()
        # RTServer.start() sets _server once its socket listens; a Unix
        # socket's path exists from bind(), before listen(), and a client
        # connecting in between is refused
        deadline = time.time() + 10
        while self.server._server is None:
            assert time.time() < deadline, "server never started listening"
            time.sleep(0.05)
        return self

    def __exit__(self, *exc):
        asyncio.run_coroutine_threadsafe(self.server.stop(),
                                         self._loop).result(30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)
        assert not self._thread.is_alive()
        self._loop.close()


def _server(path, **kw):
    """The port's server on the CPU at the JAX tests' small size."""
    kw = {"N": 20, "Tf": 1.0, "ipm_iters": 6, "max_batch": 4, **kw}
    return RTServer(str(path), device="cpu", **kw)


def _connect(address):
    tcp = RTServer.parse_tcp(address)
    if tcp:
        s = socket.create_connection(tcp, timeout=120)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    else:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(120)
        s.connect(address)
    return s


def _read(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "server closed the connection"
        buf += chunk
    return buf


def _solve1(s, seq, x0, p_obs=SENTINEL_P, r_obs=NO_R):
    s.sendall(protocol.pack_request(protocol.Request(
        seq=seq, x0=tuple(x0), p_obs=tuple(p_obs), r_obs=tuple(r_obs))))
    return protocol.unpack_response(_read(s, protocol.RESP_SIZE))


def _solve2(s, model, seq, x0, params=(), lh=(), yref=()):
    s.sendall(protocol.pack_request2(protocol.Request2(
        seq=seq, model_id=protocol.MODEL_IDS[model], x0=tuple(x0),
        params=tuple(params), lh=tuple(lh), yref=tuple(yref))))
    hdr = _read(s, protocol.RESP2_HDR_SIZE)
    _, _, _, nu, nx = struct.unpack(protocol.RESP2_HDR_FMT, hdr)
    return protocol.unpack_response2(hdr, _read(s, 4 * (nu + nx)))


def _loop1(address, n, x0=FLAGSHIP_X0):
    """`n` closed-loop v1 ticks on one connection (x0 <- x1)."""
    out = []
    with contextlib.closing(_connect(address)) as s:
        for k in range(n):
            resp = _solve1(s, k, x0)
            assert resp.seq == k
            out.append(resp)
            x0 = resp.x1
    return out


def _hull_loop2(address, n, yref=tuple(HULL.yref)):
    """`n` closed-loop v2 ticks of the hull on one connection."""
    out, x0 = [], tuple(HULL.x0)
    with contextlib.closing(_connect(address)) as s:
        for k in range(n):
            resp = _solve2(s, "usv_pf_ca", k, x0, HULL.params, HULL.lh,
                           yref)
            assert resp.seq == k
            out.append(resp)
            x0 = resp.x1
    return out


def _assert_replies_close(got, want, atol):
    for k, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.seq == w.seq and g.status == w.status, (k, g, w)
        np.testing.assert_allclose(g.u0, w.u0, rtol=0, atol=atol,
                                   err_msg=str(k))
        np.testing.assert_allclose(g.x1, w.x1, rtol=0, atol=atol,
                                   err_msg=str(k))


# ---------------------------------------------------------------------------
# the protocol

_VALS = tuple(0.25 * i - 3.0 for i in range(32))   # exact in float32
FRAMES = {
    "request": (
        lambda m: m.pack_request(m.Request(seq=7, x0=_VALS[:8],
                                           p_obs=_VALS[8:24],
                                           r_obs=_VALS[24:32])),
        lambda m, b: m.unpack_request(b)),
    "response": (
        lambda m: m.pack_response(m.Response(seq=9, status=1, u0=0.25,
                                             x1=_VALS[:8])),
        lambda m, b: m.unpack_response(b)),
    "request2": (
        lambda m: m.pack_request2(m.Request2(
            seq=5, model_id=m.MODEL_IDS["usv_pf_ca"], x0=_VALS[:14],
            params=_VALS[14:22], lh=_VALS[22:26], yref=_VALS[:16])),
        lambda m, b: m.unpack_request2_payload(
            m.unpack_request2_header(b[:m.REQ2_HDR_SIZE]),
            b[m.REQ2_HDR_SIZE:])),
    "request2_no_yref": (
        lambda m: m.pack_request2(m.Request2(
            seq=6, model_id=m.MODEL_IDS["usv_guidance_ca1"], x0=_VALS[:8],
            params=_VALS[8:24], lh=_VALS[24:32], yref=())),
        lambda m, b: m.unpack_request2_payload(
            m.unpack_request2_header(b[:m.REQ2_HDR_SIZE]),
            b[m.REQ2_HDR_SIZE:])),
    "response2": (
        lambda m: m.pack_response2(m.Response2(seq=11, status=4,
                                               u0=(0.5, -0.5),
                                               x1=_VALS[:14])),
        lambda m, b: m.unpack_response2(b[:m.RESP2_HDR_SIZE],
                                        b[m.RESP2_HDR_SIZE:])),
}


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_frames_byte_identical(kind):
    """Both modules pack the same bytes, and each unpacks the other's."""
    pack, unpack = FRAMES[kind]
    ours, theirs = pack(protocol), pack(jprotocol)
    assert ours == theirs
    assert tuple(unpack(protocol, theirs)) == tuple(unpack(jprotocol, ours))
    with pytest.raises(ValueError, match="magic"):
        unpack(protocol, b"\0" * len(ours))


def test_protocol_constants_equal():
    from mpc_collisionavoidance_tpu.rt import server as jserver
    for name in ("REQ_MAGIC", "RESP_MAGIC", "NX", "NP", "NH", "REQ_FMT",
                 "RESP_FMT", "REQ_SIZE", "RESP_SIZE", "REQ2_MAGIC",
                 "RESP2_MAGIC", "REQ2_HDR_FMT", "REQ2_HDR_SIZE",
                 "RESP2_HDR_FMT", "RESP2_HDR_SIZE", "MODEL_IDS",
                 "STATUS_BAD_REQUEST"):
        assert getattr(protocol, name) == getattr(jprotocol, name), name
    assert (protocol.REQ_SIZE, protocol.RESP_SIZE, protocol.REQ2_HDR_SIZE,
            protocol.RESP2_HDR_SIZE) == (136, 48, 20, 16)
    assert len(protocol.MODEL_IDS) == 14
    assert STATUS_OVER_CAPACITY == jserver.STATUS_OVER_CAPACITY == 3


# ---------------------------------------------------------------------------
# the server: the scenarios of tests/test_rt.py

def test_server_python_client(tmp_path):
    with _Serving(_server(tmp_path / "nmpc.sock")) as srv:
        with contextlib.closing(_connect(srv.address)) as s:
            resp = _solve1(s, 3, FLAGSHIP_X0)
    assert resp.seq == 3 and resp.status in (0, 1)
    assert np.isfinite(resp.u0)
    # with ye = -4 the controller must steer toward the path
    assert abs(resp.u0) > 1e-4


def test_server_lane_engine(tmp_path):
    """Four lanes: four vehicles hold them, a fifth gets the over-capacity
    status, a held connection reuses its warm lane, and a freed lane takes
    a new vehicle."""
    yes = (-4.0, -2.0, 3.0, 1.0)

    def x0(i):
        return (0.7, 0.0, yes[i], -AK, -AK, 0.0, 0.0, 0.0)

    with _Serving(_server(tmp_path / "nmpc.sock",
                          batch_window_ms=50.0)) as srv:
        socks = []
        for i in range(4):
            socks.append(_connect(srv.address))
            resp = _solve1(socks[i], 200 + i, x0(i))
            assert resp.seq == 200 + i and resp.status in (0, 1)
            assert abs(resp.x1[2] - yes[i]) < 0.5   # its own trajectory
        with contextlib.closing(_connect(srv.address)) as s5:
            assert _solve1(s5, 5, x0(0)).status == STATUS_OVER_CAPACITY
        assert _solve1(socks[0], 6, x0(0)).status in (0, 1)
        socks[3].close()
        time.sleep(0.3)
        with contextlib.closing(_connect(srv.address)) as s6:
            assert _solve1(s6, 7, x0(1)).status in (0, 1)
        for s in socks[:3]:
            s.close()


def test_server_lanes_under_concurrent_clients(tmp_path):
    """Ten vehicles on four lanes, joining, ticking and leaving at once
    from their own threads, with a short thread switch interval: each
    reply is its own vehicle's (x1 follows its ye) or over capacity, and
    every lane is free again afterwards (no lane lost or given twice)."""
    yes = [-4.0 + 0.8 * i for i in range(10)]
    errors = []

    def vehicle(i, address):
        try:
            x0 = (0.7, 0.0, yes[i], -AK, -AK, 0.0, 0.0, 0.0)
            with contextlib.closing(_connect(address)) as s:
                for k in range(3):
                    resp = _solve1(s, 100 * i + k, x0)
                    assert resp.seq == 100 * i + k
                    if resp.status == STATUS_OVER_CAPACITY:
                        continue
                    assert resp.status in (0, 1), resp
                    assert abs(resp.x1[2] - yes[i]) < 0.5, (i, resp)
        except Exception as exc:            # reported by the main thread
            errors.append((i, exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _Serving(_server(tmp_path / "nmpc.sock",
                              batch_window_ms=5.0)) as srv:
            threads = [threading.Thread(target=vehicle,
                                        args=(i, srv.address))
                       for i in range(10)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            deadline = time.time() + 10
            while srv.server._lane_of and time.time() < deadline:
                time.sleep(0.05)
            assert not srv.server._lane_of
            assert sorted(srv.server._lanes_free) == [0, 1, 2, 3]
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors


def test_server_lane_rti_split(tmp_path):
    """With constant params the prepare + feedback schedule gives the same
    closed-loop replies as the single-phase server."""
    with _Serving(_server(tmp_path / "a.sock")) as srv:
        ref = _loop1(srv.address, 5)
    with _Serving(_server(tmp_path / "b.sock", rti_split=True)) as srv:
        split = _loop1(srv.address, 5)
    _assert_replies_close(split, ref, atol=1e-6)


def test_server_rti_split_seed_between_prepare_and_feedback(tmp_path):
    """A vehicle joining after a preparation seeds its lane's warm start in
    place: the server drops the prepared QP and runs that tick in full, so
    every reply still equals the single-phase server's; the other ticks
    are feedback ticks."""
    x0b = (0.7, 0.0, 3.0, -AK, -AK, 0.0, 0.0, 0.0)

    def sequence(address):
        with contextlib.closing(_connect(address)) as a:
            out = [_solve1(a, 0, FLAGSHIP_X0)]
            out.append(_solve1(a, 1, out[-1].x1))
            with contextlib.closing(_connect(address)) as b:
                out.append(_solve1(b, 2, x0b))          # seeds lane 1
                out.append(_solve1(a, 3, out[1].x1))
                out.append(_solve1(b, 4, out[2].x1))
        return out

    with _Serving(_server(tmp_path / "a.sock")) as srv:
        ref = sequence(srv.address)
    server = _server(tmp_path / "b.sock", rti_split=True)
    feedback_ticks = []
    feedback = server._feedback

    def counted(x0_rows):
        feedback_ticks.append(1)
        return feedback(x0_rows)

    server._feedback = counted
    with _Serving(server) as srv:
        feedback_ticks.clear()                          # warmup's
        split = sequence(srv.address)
    _assert_replies_close(split, ref, atol=1e-6)
    # ticks 1, 3 and 4 are feedback ticks; tick 0 and the joining tick 2
    # run in full
    assert len(feedback_ticks) == 3


def test_server_tcp_transport(tmp_path):
    """A `host:port` listener serves the same frames; a TCP closed loop
    equals a UDS one tick for tick."""
    with _Serving(_server("127.0.0.1:0")) as srv:
        port = srv.server.bound_port
        assert port and srv.address == f"127.0.0.1:{port}"
        tcp = _loop1(srv.address, 5)
    with _Serving(_server(tmp_path / "uds.sock")) as srv:
        uds = _loop1(srv.address, 5)
    _assert_replies_close(tcp, uds, atol=1e-6)


def test_server_v2_rejects_mismatched_dims_and_v1(tmp_path):
    """A hull server answers BAD_REQUEST to a wrong model id, a wrong nx
    and flagship v1 frames, and keeps serving."""
    with _Serving(_server(tmp_path / "pf.sock", model="usv_pf_ca", N=20,
                          Tf=0.2)) as srv:
        with contextlib.closing(_connect(srv.address)) as s:
            resp = _solve2(s, "usv_guidance_ca1", 0, [0.0] * 8)
            assert resp.status == protocol.STATUS_BAD_REQUEST
            assert (len(resp.u0), len(resp.x1)) == (2, 14)
            resp = _solve2(s, "usv_pf_ca", 1, [0.0] * 8)
            assert resp.status == protocol.STATUS_BAD_REQUEST
            resp = _solve2(s, "usv_pf_ca", 2, HULL.x0, HULL.params,
                           HULL.lh)
            assert resp.seq == 2 and resp.status in (0, 1)
            assert np.all(np.isfinite(resp.x1))
        with contextlib.closing(_connect(srv.address)) as s:
            resp = _solve1(s, 7, FLAGSHIP_X0)
            assert resp.status == protocol.STATUS_BAD_REQUEST


def test_server_v2_wire_yref_reaches_the_lane(tmp_path):
    """A v2 frame's yref becomes its lane's reference: the same hull
    request with and without the scenario's yref (surge 0.7 m/s along the
    segment) gets different replies, and lanes without one keep the
    builder's."""
    with _Serving(_server(tmp_path / "pf.sock", model="usv_pf_ca", N=20,
                          Tf=0.2)) as srv:
        with_yref = _hull_loop2(srv.address, 2)
        builder = _hull_loop2(srv.address, 2, yref=())
        zeros = _hull_loop2(srv.address, 2, yref=(0.0,) * 16)
    assert max(abs(a - b) for a, b in zip(with_yref[-1].x1,
                                          builder[-1].x1)) > 1e-4
    # the hull builder's yref is zero: an explicit zero yref is the same
    _assert_replies_close(zeros, builder, atol=0)


def test_unported_engine_and_model_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="A7"):
        RTServer(str(tmp_path / "x.sock"), engine="vmap", device="cpu")
    with pytest.raises(ValueError, match="usv_pf_ca"):
        RTServer(str(tmp_path / "x.sock"), model="no_such_model",
                 device="cpu")


def test_cuda_device_missing_is_an_error(tmp_path):
    """`--device cuda` on a host without CUDA exits non-zero with a
    message; the constructor raises.  Nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(ValueError, match="CUDA"):
        RTServer(str(tmp_path / "x.sock"), device="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "mpc_collisionavoidance_tpu_torch.rt.server",
         str(tmp_path / "x.sock"), "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "x.sock").exists()


# ---------------------------------------------------------------------------
# the slice against JAX

def test_wire_loop_matches_jax_server(tmp_path):
    """The same 5-tick wire closed loop through the JAX lane server and the
    port's server, identical arguments, both float32.  Statuses must be
    identical.  The two take their float32 operations in other orders, so
    u0/x1 agree to round-off, not bitwise: measured within 6e-8 (one
    float32 ulp of u0), held at atol 1e-6."""
    from mpc_collisionavoidance_tpu.rt.server import RTServer as JaxServer
    kw = dict(N=20, Tf=1.0, ipm_iters=6, max_batch=4)
    with _Serving(JaxServer(str(tmp_path / "j.sock"), engine="lane",
                            **kw)) as srv:
        ref = _loop1(srv.address, 5)
    with _Serving(RTServer(str(tmp_path / "t.sock"), device="cpu",
                           **kw)) as srv:
        ours = _loop1(srv.address, 5)
    _assert_replies_close(ours, ref, atol=1e-6)


@pytest.mark.parametrize("model", ["usv_low_level", "usv_acados"])
def test_wire_loop_of_a_model_with_no_rows_matches_jax_server(tmp_path,
                                                              model):
    """A model with no parameters and no constraint rows over v2 frames
    (np = nh = 0, the scenario's yref): a 4-tick wire closed loop through
    the JAX lane server and the port's, identical arguments, both float32;
    identical statuses, u0/x1 to float32 round-off.  The thrust rates run
    at 16-30 (one float32 ulp: 1.9e-6) in QPs with no control cost (R = 0
    in usv_low_level's), and the two packages take their float32
    operations in other orders: measured within 5.7e-6, held at 1e-6 of
    the +-30 bound (atol 3e-5)."""
    from mpc_collisionavoidance_tpu.rt.server import RTServer as JaxServer
    kw = dict(model=model, N=20, Tf=1.0, ipm_iters=6, max_batch=4)
    sc = scenarios.DEFAULTS[model][0]()
    replies = []
    for server in (JaxServer(str(tmp_path / "j.sock"), engine="lane", **kw),
                   RTServer(str(tmp_path / "t.sock"), device="cpu", **kw)):
        out, x0 = [], tuple(sc.x0)
        with _Serving(server) as srv, \
                contextlib.closing(_connect(srv.address)) as s:
            for k in range(4):
                out.append(_solve2(s, model, k, x0, yref=tuple(sc.yref)))
                assert out[-1].seq == k and out[-1].status in (0, 1)
                x0 = out[-1].x1
        replies.append(out)
    _assert_replies_close(replies[1], replies[0], atol=3e-5)


@pytest.mark.parametrize("model", ["usv_guidance_ca", "usv_guidance4"])
def test_wire_loop_of_a_guidance_model_matches_jax_server(tmp_path, model):
    """A guidance model over v2 frames: usv_guidance_ca with its 16
    obstacle parameters, runtime lh and 8 hard rows, and usv_guidance4
    with np = nh = 0 and no state box; the scenario's x0 and the
    builder's yref (the scenarios carry none).  A 5-tick wire closed loop
    through the JAX lane server and the port's, identical arguments, both
    float32; identical statuses, u0/x1 to float32 round-off (measured
    within 1.5e-7, held at 1e-6 as the flagship's loop is)."""
    from mpc_collisionavoidance_tpu.rt.server import RTServer as JaxServer
    kw = dict(model=model, N=20, Tf=1.0, ipm_iters=6, max_batch=4)
    sc = scenarios.DEFAULTS[model][0]()
    replies = []
    for server in (JaxServer(str(tmp_path / "j.sock"), engine="lane", **kw),
                   RTServer(str(tmp_path / "t.sock"), device="cpu", **kw)):
        out, x0 = [], tuple(sc.x0)
        with _Serving(server) as srv, \
                contextlib.closing(_connect(srv.address)) as s:
            for k in range(5):
                out.append(_solve2(s, model, k, x0, sc.params, sc.lh))
                assert out[-1].seq == k and out[-1].status in (0, 1)
                x0 = out[-1].x1
        replies.append(out)
    _assert_replies_close(replies[1], replies[0], atol=1e-6)


def test_wire_loop_of_race_cars_matches_jax_server(tmp_path):
    """race_cars over v2 frames, on the straight track as both servers
    build it: no parameters, the model's 5 bounds as lh per request (2
    soft rows, 3 hard), 3 RK4 substeps; the race scenario's x0 and the
    builder's yref.  A 4-tick wire closed loop through the JAX lane
    server and the port's, identical arguments, both float32; identical
    statuses, u0/x1 to float32 round-off: the duty rate runs at 1-10 (one
    float32 ulp: 9.5e-7 at 10) and the two packages take their float32
    operations in other orders, measured within 4.8e-6, held at 1e-6 of
    the +-10 bound (atol 1e-5)."""
    from mpc_collisionavoidance_tpu.rt.server import RTServer as JaxServer
    model = "race_cars"
    kw = dict(model=model, N=20, Tf=1.0, ipm_iters=6, max_batch=4)
    sc = scenarios.DEFAULTS[model][0]()
    replies = []
    for server in (JaxServer(str(tmp_path / "j.sock"), engine="lane", **kw),
                   RTServer(str(tmp_path / "t.sock"), device="cpu", **kw)):
        out, x0 = [], tuple(sc.x0)
        with _Serving(server) as srv, \
                contextlib.closing(_connect(srv.address)) as s:
            for k in range(4):
                out.append(_solve2(s, model, k, x0, sc.params, sc.lh))
                assert out[-1].seq == k and out[-1].status in (0, 1)
                x0 = out[-1].x1
        replies.append(out)
    _assert_replies_close(replies[1], replies[0], atol=1e-5)


# ---------------------------------------------------------------------------
# the unchanged C++ client

class _CRequest(ctypes.Structure):
    _pack_ = 1
    _fields_ = [("magic", ctypes.c_uint32), ("seq", ctypes.c_uint32),
                ("x0", ctypes.c_float * 8), ("p_obs", ctypes.c_float * 16),
                ("r_obs", ctypes.c_float * 8)]


class _CResponse(ctypes.Structure):
    _pack_ = 1
    _fields_ = [("magic", ctypes.c_uint32), ("seq", ctypes.c_uint32),
                ("status", ctypes.c_uint32), ("u0", ctypes.c_float),
                ("x1", ctypes.c_float * 8)]


def _client_library(tmp_path):
    """Build rt_client's shared library with cmake and bind its C API
    (rt_client/nmpc_rt_client.h)."""
    build = tmp_path / "build"
    subprocess.run(["cmake", "-S", str(REPO / "rt_client"), "-B",
                    str(build), "-DCMAKE_BUILD_TYPE=Release"], check=True,
                   capture_output=True, timeout=300)
    subprocess.run(["cmake", "--build", str(build), "--target",
                    "nmpc_rt_client"], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(build / "libnmpc_rt_client.so"))
    fp = ctypes.POINTER(ctypes.c_float)
    u16, u32 = ctypes.c_uint16, ctypes.c_uint32
    lib.nmpc_rt_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.nmpc_rt_connect.restype = ctypes.c_void_p
    lib.nmpc_rt_solve.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(_CRequest),
                                  ctypes.POINTER(_CResponse)]
    lib.nmpc_rt_solve.restype = ctypes.c_int
    lib.nmpc_rt_solve2.argtypes = [ctypes.c_void_p, u16, u32, fp, u16, fp,
                                   u16, fp, u16, fp, u16, fp, u16, fp,
                                   ctypes.POINTER(u32), ctypes.POINTER(u16)]
    lib.nmpc_rt_solve2.restype = ctypes.c_int
    lib.nmpc_rt_close.argtypes = [ctypes.c_void_p]
    lib.nmpc_rt_close.restype = None
    return lib


def _floats(vals):
    return (ctypes.c_float * max(len(vals), 1))(*vals)


def _cpp_loop1(lib, address, n):
    c = lib.nmpc_rt_connect(address.encode(), 60000)
    assert c, "nmpc_rt_connect failed"
    req, out = _CRequest(), []
    req.x0[:] = FLAGSHIP_X0
    req.p_obs[:] = SENTINEL_P
    req.r_obs[:] = NO_R
    try:
        for k in range(n):
            req.seq = k
            resp = _CResponse()
            assert lib.nmpc_rt_solve(c, ctypes.byref(req),
                                     ctypes.byref(resp)) == 0
            out.append(protocol.Response(seq=resp.seq, status=resp.status,
                                         u0=resp.u0, x1=tuple(resp.x1)))
            req.x0[:] = list(resp.x1)
    finally:
        lib.nmpc_rt_close(c)
    return out


def _cpp_hull_loop2(lib, address, n):
    c = lib.nmpc_rt_connect(address.encode(), 60000)
    assert c, "nmpc_rt_connect failed"
    x0, out = tuple(HULL.x0), []
    try:
        for k in range(n):
            u0, x1 = _floats([0.0] * 2), _floats([0.0] * 14)
            status, nu = ctypes.c_uint32(), ctypes.c_uint16()
            assert lib.nmpc_rt_solve2(
                c, protocol.MODEL_IDS["usv_pf_ca"], k, _floats(x0), 14,
                _floats(HULL.params), 8, _floats(HULL.lh), 4,
                _floats(HULL.yref), 16, u0, 2, x1, ctypes.byref(status),
                ctypes.byref(nu)) == 0
            assert nu.value == 2
            out.append(protocol.Response2(seq=k, status=status.value,
                                          u0=tuple(u0), x1=tuple(x1)))
            x0 = tuple(x1)
    finally:
        lib.nmpc_rt_close(c)
    return out


def test_cpp_client_library_drives_the_port(tmp_path):
    """The unchanged C++ client library (ctypes) against the port's CPU
    server: 3 v1 flagship ticks and 3 v2 hull ticks, each equal to the
    Python client's replies from a fresh server of the same arguments."""
    if shutil.which("cmake") is None or shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (cmake and g++)")
    lib = _client_library(tmp_path)
    replies = {}
    for client in ("cpp", "python"):
        with _Serving(_server(tmp_path / f"f_{client}.sock")) as srv:
            replies[client, 1] = (_cpp_loop1(lib, srv.address, 3)
                                  if client == "cpp"
                                  else _loop1(srv.address, 3))
        with _Serving(_server(tmp_path / f"h_{client}.sock",
                              model="usv_pf_ca", N=20, Tf=0.2)) as srv:
            replies[client, 2] = (_cpp_hull_loop2(lib, srv.address, 3)
                                  if client == "cpp"
                                  else _hull_loop2(srv.address, 3))
    for version in (1, 2):
        assert replies["cpp", version] == replies["python", version]
        assert all(r.status in (0, 1) for r in replies["cpp", version])
