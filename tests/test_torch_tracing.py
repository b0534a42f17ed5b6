"""The port's tracer (`utils/profiling.py`): spans, ids, counters, the
profiler's ranges, the fleet tick's and the RT server's spans, and the
benchmark's readers of the program trace (`port_bench/metrics/`).

The CPU tests take a few seconds.  The `cuda`-marked ones need the card:

    python -m pytest tests/test_torch_tracing.py -q -rs -m cuda --noconftest
"""

import contextlib
import importlib.util
import pathlib
import socket

import numpy as np
import pytest
import torch

from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.rt import protocol
from mpc_collisionavoidance_tpu_torch.rt.server import STAGES, RTServer
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetMissionEngine
from mpc_collisionavoidance_tpu_torch.utils import profiling
from port_bench.metrics import _trace

METRICS = pathlib.Path(__file__).resolve().parents[1] / "port_bench" / \
    "metrics"


@pytest.fixture
def tracer():
    """Tracing on, on the host only; off again after the test."""
    profiling.enable_tracing("cpu")
    yield
    profiling.disable_tracing()


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the tracer

def test_off_records_nothing():
    profiling.disable_tracing()
    a, b = profiling.span("a"), profiling.span("b", id=3)
    assert a is b is profiling._NULL
    with a:
        profiling.count("n", 2)
    assert profiling.stamper("lane.step", "cpu") is None
    assert profiling.new_id() is None and not profiling.tracing()
    assert profiling.records() == {}


def test_on_parents_ids_and_counters(tracer):
    with profiling.span("tick") as outer:
        with profiling.span("a"):
            profiling.count("n")
            with profiling.span("b"):
                profiling.count("n", 2)
    with profiling.span("tick"):
        pass
    with profiling.span("req", id=77):
        with profiling.span("inner"):
            pass
    rid = profiling.new_id()
    profiling.add_span("server.queue", 10, 20, rid)
    rec = profiling.records()
    assert rec["counters"] == {"n": 3} and rec["device"] is None
    spans = {(s["name"], s["id"]): s for s in rec["spans"]}
    first = spans["tick", outer[3]]
    a, b = spans["a", outer[3]], spans["b", outer[3]]
    assert first["parent"] is None
    assert a["parent"] == first["seq"] and b["parent"] == a["seq"]
    second = [s for s in rec["spans"] if s["name"] == "tick"
              and s["id"] != first["id"]]
    assert len(second) == 1
    assert spans["inner", 77]["parent"] == spans["req", 77]["seq"]
    assert rid not in (first["id"], second[0]["id"], 77)
    assert spans["server.queue", rid]["host"] == [10, 20]
    for s in (first, a, b):
        assert s["host"][0] <= s["host"][1] and s["device"] is None
    assert first["host"][0] <= a["host"][0] <= b["host"][0]
    assert b["host"][1] <= a["host"][1] <= first["host"][1]
    # records() hands everything over once
    again = profiling.records()
    assert again["spans"] == [] and again["counters"] == {}


def test_spans_are_profiler_ranges(tracer):
    x = torch.ones(256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            x = x.cumsum(0)
            with profiling.span("inner"):
                x = x.mul(2.0)
    events = prof.events()

    def one(name):
        found = [e for e in events if e.name == name]
        assert found, name
        return found[0].time_range

    outer, inner = one("outer"), one("inner")
    cumsum, mul = one("aten::cumsum"), one("aten::mul")
    assert outer.start <= cumsum.start and cumsum.end <= outer.end
    assert inner.start <= mul.start and mul.end <= inner.end
    assert outer.start <= inner.start and inner.end <= outer.end


def test_fleet_tick_spans(tracer):
    B = 2
    field, valid = scenarios.challenge0_field()
    wps = np.broadcast_to(np.array([[4.0, -5.0], [4.0, 25.0]]),
                          (B, 2, 2)).copy()
    meas0 = (np.full(B, 0.7), np.zeros(B), np.array([-0.3, 0.3]),
             np.zeros(B), np.zeros(B))
    fleet = FleetMissionEngine(builders.usv_guidance_ca1(Tf=1.0, N=10),
                               ipm_iters=3, device="cpu",
                               dtype=torch.float64)
    fleet.run(meas0, wps, np.full(B, 2), field, valid, n_steps=2)
    rec = profiling.records()
    ticks = _trace.by_id(rec, {"fleet.tick"})
    assert len(ticks) == 2
    want = ["fleet.waypoints", "fleet.perceive", "fleet.pack",
            "fleet.solve", "fleet.plant", "fleet.log"]
    for tid, (tick,) in ticks.items():
        kids = sorted((s for s in rec["spans"] if s["id"] == tid
                       and s["parent"] == tick["seq"]),
                      key=lambda s: s["host"][0])
        assert [s["name"] for s in kids] == want
        # the plant's RK4 integrator is its own span inside `fleet.plant`
        inner = [s for s in rec["spans"] if s["parent"] == kids[4]["seq"]]
        assert [s["name"] for s in inner] == ["fleet.integrate"]
        for p, q in zip(kids, kids[1:]):
            assert p["host"][1] <= q["host"][0]


def _solve(address, x0):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(60)
    s.connect(address)
    with contextlib.closing(s):
        s.sendall(protocol.pack_request(protocol.Request(
            seq=1, x0=tuple(x0), p_obs=(100.0,) * 16, r_obs=(0.0,) * 8)))
        buf = b""
        while len(buf) < protocol.RESP_SIZE:
            chunk = s.recv(protocol.RESP_SIZE - len(buf))
            assert chunk
            buf += chunk
    return protocol.unpack_response(buf)


def _request_spans(tmp_path, device):
    """One request through a server on `device`: six spans, one id, one
    after another; `server.tick` is the `solve_ms` entry."""
    import asyncio
    import threading
    server = RTServer(str(tmp_path / "s.sock"), N=10, Tf=1.0, ipm_iters=3,
                      max_batch=2, batch_window_ms=1.0, device=device)
    server.warmup()
    profiling.records()
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    assert started.wait(30)
    try:
        resp = _solve(server.path, (0.7, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0,
                                    0.0))
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
    assert resp.status in (0, 1)
    rec = profiling.records()
    spans = [s for s in rec["spans"] if s["name"].startswith("server.")]
    assert [s["name"] for s in spans] == list(STAGES)
    assert len({s["id"] for s in spans}) == 1
    for p, q in zip(spans, spans[1:]):
        assert p["host"][0] <= p["host"][1] == q["host"][0]
    tick = spans[STAGES.index("server.tick")]["host"]
    assert list(server.solve_ms) == [(tick[1] - tick[0]) * 1e-6]


def test_server_request_spans(tracer, tmp_path):
    _request_spans(tmp_path, "cpu")


# ---------------------------------------------------------------------------
# the readers of the program trace

def _synthetic():
    """A window of two fleet ticks (lane.step: 10 ms with escalation
    steps of 1 and 2 ms in the first, one of 3 ms in the second; the
    guidance spans 1 ms each on the host, 0.5 ms on the device; work of
    the caller's, queued before the second tick, runs after the host
    starts it, so only the first tick starts on a drained device) and two
    node ticks (instance.step: QP built at 2 ms, 18 iterations over 9 ms,
    tick 12 ms)."""
    ms = 1_000_000
    spans, stamps, seq = [], [], iter(range(1, 1000))
    for tid, t0 in ((1, 0), (2, 100 * ms)):
        t, top = t0, next(seq)
        spans.append(dict(name="fleet.tick", seq=top, parent=None, id=tid,
                          thread="m", host=[t, t + 16 * ms],
                          device=[t + ms, t + 16 * ms + ms // 2]))
        for name in ("fleet.waypoints", "fleet.perceive", "fleet.pack"):
            spans.append(dict(name=name, seq=next(seq), parent=top, id=tid,
                              thread="m", host=[t, t + ms],
                              device=[t + ms, t + ms + ms // 2]))
            t += ms
        spans.append(dict(name="lane.launch", seq=next(seq), parent=top,
                          id=tid, thread="m", host=[t, t + ms // 10],
                          device=[t, t + 10 * ms + ms // 10]))
        stamps.append([t + 10_000, 1, "tick.start", 0])
        steps = [(2 * ms, 3 * ms), (5 * ms, 7 * ms)] if tid == 1 else \
            [(4 * ms, 7 * ms)]
        for k, (a, b) in enumerate(steps):
            stamps += [[t + a, 1, "esc.start", k], [t + b, 1, "esc.end", k]]
        stamps.append([t + 10 * ms + 10_000, 1, "tick.end", 0])
        t += 11 * ms
        for name in ("fleet.plant", "fleet.log"):
            spans.append(dict(name=name, seq=next(seq), parent=top, id=tid,
                              thread="m", host=[t, t + ms],
                              device=[t + ms, t + ms + ms // 2]))
            t += ms
    spans.append(dict(name="caller.work", seq=next(seq), parent=None, id=9,
                      thread="m", host=[99 * ms, 99 * ms + ms // 2],
                      device=[101 * ms, 101 * ms + ms // 5]))
    for t in (300 * ms, 320 * ms):
        stamps += [[t, 2, "tick.start", 0], [t + 2 * ms, 2, "qp.built", 0],
                   [t + 2 * ms, 2, "ipm.start", 0],
                   [t + 11 * ms, 2, "ipm.end", 18],
                   [t + 12 * ms, 2, "tick.end", 0]]
    return dict(device="card", counters={}, dropped_stamps=0, spans=spans,
                stamps=stamps,
                programs=[dict(id=1, name="lane.step", esc_steps=3),
                          dict(id=2, name="instance.step", esc_steps=0)])


@pytest.mark.parametrize("name, want", [
    ("guidance_host_ms", 5.0), ("guidance_device_ms", 2.5),
    ("lane_fixed_ms", 7.0), ("esc_step_ms", 2.0),
    ("instance_qp_ms", 2.0), ("instance_ipm_iter_ms", 0.5)])
def test_program_trace_readers(name, want):
    read = _reader(name)
    assert read({"program_trace": _synthetic()}) == pytest.approx(want)
    assert read({}) is None
    assert read({"program_trace": {}}) is None
    empty = dict(_synthetic(), spans=[], stamps=[])
    assert read({"program_trace": empty}) is None


def test_guidance_readings_split_by_drained_ticks():
    """The host reading takes the ticks that start on a drained device,
    the device reading the others (the host ahead of the device); on a
    host-only trace every tick is drained."""
    ms = 1_000_000
    trace = _synthetic()
    t = 116 * ms + ms // 5       # the second tick's work runs to 116.5 ms
    spans = [dict(name="fleet.tick", seq=900, parent=None, id=3,
                  thread="m", host=[t, t + 15 * ms],
                  device=[t + ms, t + 16 * ms])]
    for k, name in enumerate(("fleet.waypoints", "fleet.perceive",
                              "fleet.pack", "fleet.plant", "fleet.log")):
        a = t + 3 * k * ms
        spans.append(dict(name=name, seq=901 + k, parent=900, id=3,
                          thread="m", host=[a, a + 3 * ms],
                          device=[a + ms, a + 2 * ms]))
    trace["spans"] += spans
    assert _trace.drained(trace, "fleet.tick") == {1}
    read, device = _reader("guidance_host_ms"), _reader("guidance_device_ms")
    assert read({"program_trace": trace}) == pytest.approx(5.0)
    assert device({"program_trace": trace}) == pytest.approx(3.75)
    host = dict(trace, spans=[dict(s, device=None) for s in trace["spans"]])
    assert _trace.drained(host, "fleet.tick") == {1, 2, 3}
    assert read({"program_trace": host}) == pytest.approx(25.0 / 3)
    assert device({"program_trace": host}) is None


def test_host_gaps_and_one_clock():
    trace = _synthetic()
    gaps = _trace.host_gaps(trace, n=20)
    # the longest: after the first tick's fleet.log on the device, while
    # the host has no span open, to the second tick's first span; then
    # the graph's end to fleet.plant's work, while the host is in the tick
    # (the tick's own interval, a parent's, covers none of them)
    assert gaps[:3] == [["(no span)", pytest.approx(0.0845)],
                        ["fleet.tick", pytest.approx(0.0019)],
                        ["fleet.tick", pytest.approx(0.0019)]]
    # between the guidance spans' work the host is in the next span
    assert {g[0] for g in gaps[3:]} == {"fleet.perceive", "fleet.pack",
                                        "fleet.log"}
    assert len(gaps) == 9
    assert _trace.clock_violations(trace) == (2, 0, 0)
    late = dict(trace, stamps=[[t + 200_000, *rest] if rest[1] == "tick.end"
                               else [t, *rest] for t, *rest in
                               trace["stamps"]])
    checked, bad, worst = _trace.clock_violations(late)
    assert (checked, bad) == (2, 2) and worst == pytest.approx(110_000)
    split = _trace.instance_split(trace)
    assert split == pytest.approx(dict(qp=2.0, ipm_setup=0.0, ipm=9.0,
                                       finish=1.0, tick=12.0))


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the device stamps run only on the card "
                    "(python -m pytest tests/test_torch_tracing.py -m cuda "
                    "-rs --noconftest on the GPU machine)")
    from mpc_collisionavoidance_tpu_torch.kernels import _build
    try:
        _build.find_nvcc()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    yield torch.device("cuda")
    profiling.disable_tracing()


def _lane_ticks(device, traced, ticks=3):
    """A hull lane solver at L=64 on the production schedule, captured
    with tracing on or off; `ticks` ticks from one warm start."""
    from mpc_collisionavoidance_tpu_torch.config import production_engine
    from mpc_collisionavoidance_tpu_torch.solver.batch import to_lanes
    spec = builders.usv_pf_ca(Tf=1.0, N=100)
    sc = scenarios.pf_ca_default()
    L = 64
    rng = np.random.default_rng(0)
    x0 = np.broadcast_to(np.asarray(sc.x0, np.float64), (L, spec.model.nx))
    x0 = x0 + rng.normal(0, 0.05, x0.shape)
    if traced:
        profiling.enable_tracing(device)
    else:
        profiling.disable_tracing()
    solver = production_engine().build(spec, device=device,
                                       dtype=torch.float32)
    state = solver.init_state(x0)
    xs = to_lanes(torch.as_tensor(x0, dtype=torch.float32, device=device))
    p = torch.as_tensor(np.asarray(sc.params, np.float32),
                        device=device)[:, None].expand(-1, L).contiguous()
    for _ in range(ticks):
        state, out = solver.step_fn(state, xs, p)
        xs = out.x1.clone()
    torch.cuda.synchronize()
    (program,) = solver._graphs.programs.values()
    return program, profiling.records() if traced else None


@pytest.mark.cuda
def test_lane_tick_stamps(card):
    plain, _ = _lane_ticks(card, traced=False)
    assert plain.stamp_nodes == 0
    program, rec = _lane_ticks(card, traced=True)
    assert program.nodes == plain.nodes and program.stamp_nodes > 0
    # 2 per tick and 2 per escalation step the graph holds
    assert program.stamp_nodes == 2 + 2 * program.conditional
    ticks = _trace.ticks(rec, "lane.step")
    assert len(ticks) == 3
    for t in ticks:
        times = [t["start"]] + [x for _, _, x in t["points"]] + [t["end"]]
        assert times == sorted(times)
    (prog,) = [p for p in rec["programs"] if p["name"] == "lane.step"]
    assert prog["esc_steps"] == sum(len(_trace.esc_steps(t)) for t in ticks)
    checked, bad, worst = _trace.clock_violations(rec)
    assert (checked, bad) == (3, 0), worst
    # each call's copy-in and launch share the call's id
    calls = _trace.by_id(rec, {"lane.step", "lane.copy_in", "lane.launch"})
    assert len(calls) == 3
    assert all(sorted(s["name"] for s in c) ==
               ["lane.copy_in", "lane.launch", "lane.step"]
               for c in calls.values())


@pytest.mark.cuda
def test_server_request_spans_on_card(card, tmp_path):
    profiling.enable_tracing(card)
    _request_spans(tmp_path, "cuda")


@pytest.mark.cuda
def test_instance_tick_stamps(card):
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    spec = builders.usv_pf_ca(Tf=1.0, N=100)
    sc = scenarios.pf_ca_default()
    nodes = {}
    for traced in (False, True):
        if traced:
            profiling.enable_tracing(card)
        solver = RTISolver(spec, device=card, dtype=torch.float32)
        state = solver.init_state(np.asarray(sc.x0, np.float32))
        for _ in range(2):
            state, out = solver.step_fn(state, np.asarray(sc.x0, np.float32),
                                        np.asarray(sc.params, np.float32))
        torch.cuda.synchronize()
        (program,) = solver._graphs.programs.values()
        nodes[traced] = (program.nodes, program.stamp_nodes)
    assert nodes[True][0] == nodes[False][0] and nodes[False][1] == 0
    assert nodes[True][1] == 5
    rec = profiling.records()
    split = _trace.instance_split(rec)
    assert 0 < split["qp"] < split["tick"] and split["ipm"] > 0
    assert _trace.clock_violations(rec, "instance.step")[:2] == (2, 0)
