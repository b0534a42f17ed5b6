"""Tracing / profiling utilities (counterpart of
`mpc_collisionavoidance_tpu/utils/profiling.py`), and the port's tracer.

The reference's only instrumentation is wall-clock around each solve with
a running sum/max printed at exit (reference
scripts/usv_guidance_ca1/main.py:133-144,197-198).  `SolveTimer` keeps that
exact surface (avg/max, plus percentiles and solves/s) on the host clock:
CUDA work is asynchronous, so a caller synchronizes the device inside
`tick()` (`torch.cuda.synchronize()`, as the JAX package's callers call
`block_until_ready`).  `trace` wraps `torch.profiler` for per-kernel
timelines, and `device_memory_stats` reads the card's allocator.

The tracer.  Off by default: `span(name)` then returns one shared null
context and `count(name, n)` returns at once.  `enable_tracing()` turns
it on; from then on

- `span(name, id=None)` records a span: its name, the span open around
  it on the same thread (its parent), an id that one tick or one request
  shares (a span with no parent and no `id` takes a new one; a nested
  span takes its parent's), its host start and end on
  `time.perf_counter_ns()`, on a CUDA device a pooled CUDA event at each
  end on the current stream (the device interval of the work the span
  submitted), and, while a `torch.profiler` runs, a `record_function`
  range of the same name on the profiler's timeline;
- `count(name, n)` adds to a counter;
- a program captured by `solver/capture.py` stamps the device: a
  one-thread kernel (`csrc/stamp.cu`) writes `%globaltimer` and a tag
  into a device ring at named points of the tick (`Stamper`);
- `records()` hands everything recorded since the last call (or since
  `enable_tracing()`) back and forgets it.  The host clock is the one
  clock: two anchors, one at the previous call (or at `enable_tracing()`)
  and one at this call, each a CUDA event and a stamp run back to back
  on the device, paired with a host reading, and the events' and the
  stamps' times are mapped linearly onto host ns between them.

Everything stays in memory until `records()`.  `disable_tracing()` turns
the tracer off and drops what it holds (a graph captured with tracing on
keeps stamping the ring, which nothing reads).
"""

import collections
import contextlib
import ctypes
import itertools
import os
import threading
import time
from typing import Optional

import numpy as np
import torch


class SolveTimer:
    """Accumulates per-solve wall-clock like the reference harness.

    >>> timer = SolveTimer(batch=4096)
    >>> with timer.tick():
    ...     run_one_step()
    ...     torch.cuda.synchronize()
    >>> print(timer.summary())
    """

    def __init__(self, batch: int = 1):
        self.batch = batch
        self.samples = []

    @contextlib.contextmanager
    def tick(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    # reference names: avg/max compute time (main.py:197-198)
    @property
    def avg(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    @property
    def max(self) -> float:
        return float(np.max(self.samples)) if self.samples else 0.0

    def percentile(self, q) -> float:
        return float(np.percentile(self.samples, q)) if self.samples else 0.0

    @property
    def solves_per_s(self) -> float:
        total = float(np.sum(self.samples))
        return len(self.samples) * self.batch / total if total else 0.0

    def summary(self) -> dict:
        return {
            "ticks": len(self.samples),
            "batch": self.batch,
            "avg_ms": 1e3 * self.avg,
            "max_ms": 1e3 * self.max,
            "p50_ms": 1e3 * self.percentile(50),
            "p99_ms": 1e3 * self.percentile(99),
            "solves_per_s": self.solves_per_s,
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope over the host and, where there is one, the
    CUDA device; writes a Chrome trace (chrome://tracing, Perfetto) to
    `log_dir/trace.json`.

    A captured tick's kernels show up in it, those inside the graph's
    conditional nodes too (the lane tick's escalation steps,
    `solver/capture.py`): K1's launches in a profiled hull lane tick are
    its 4 fixed ones plus one per escalation step that ran, as the
    tracer's device stamps count them.  With the tracer on, its spans
    are `record_function` ranges in the trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> Optional[dict]:
    """The caching allocator's device memory: bytes in use, the peak since
    the process started (or `torch.cuda.reset_peak_memory_stats`) and the
    card's total; None for a CPU device.  `device`: None = the current
    CUDA device where there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(device)[1]}


# ---------------------------------------------------------------------------
# the tracer

#: stamps the device ring holds: a 20 s window of the hull fleet's lane
#: ticks takes ~20,000 (two per escalation step, up to 24 steps a tick)
RING_ENTRIES = 1 << 18
#: CUDA events made at `enable_tracing()`: two per span, ~18,000 for the
#: flagship fleet's 20 s window.  torch makes a CUDA event at its first
#: record, so each is recorded once there, outside the traced work.
POOL_EVENTS = 1 << 15

_NULL = contextlib.nullcontext()
_tracer = None                 # the active _Tracer; None: tracing is off
# device index -> (ring, count); a ring is never freed, since a graph
# captured with tracing on writes into it at every launch
_rings = {}
_points = {}                   # stamp point name -> code
_point_names = {}              # code -> name
_program_ids = itertools.count(1)
_stampers = []                 # every program that stamps, in capture order


def _launch_stamp(ring, device, tag):
    """Queue the stamp kernel on `device`'s current stream."""
    from mpc_collisionavoidance_tpu_torch.kernels import _build
    ring, n = ring
    stream = torch.cuda.current_stream(device).cuda_stream
    code = _build.library().nmpc_stamp(
        ring.data_ptr(), n.data_ptr(), ring.shape[0], tag, stream)
    if code:
        raise RuntimeError(f"stamp kernel launch failed (code {code})")


def _point(name):
    code = _points.get(name)
    if code is None:
        code = _points.setdefault(name, len(_points) + 1)
        _point_names[code] = name
    return code


class _Tracer:
    """What `enable_tracing()` records until `records()` takes it."""

    def __init__(self, device):
        self.device = device            # a CUDA device, or None (host only)
        self.lock = threading.Lock()
        self.local = threading.local()
        self.spans = []                 # finished spans, in end order
        self.counters = collections.Counter()
        self.ids = itertools.count(1)
        self.seqs = itertools.count(1)
        self.events = []                # the pool of CUDA events
        self.streams = {}               # current-stream key -> Stream
        self.ring = None
        if device is None:
            return
        with torch.cuda.device(device):
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(POOL_EVENTS)]
            for ev in self.events:
                ev.record()
            ring = _rings.get(device.index)
            if ring is None:
                ring = (torch.zeros((RING_ENTRIES, 2), dtype=torch.int64,
                                    device=device),
                        torch.zeros((), dtype=torch.int64, device=device))
                _rings[device.index] = ring
            ring[1].zero_()
            self.ring = ring
            # a first launch loads the kernel (~0.1 ms late): not in an anchor
            _launch_stamp(self.ring, self.device, 0)
            self.read = 1               # stamps taken by records() so far
            self.anchor = self._anchor()

    def stack(self):
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self):
        """A pooled CUDA event, recorded on the device's current stream
        (its `Stream` object kept per stream: `torch.cuda.current_stream()`
        makes one at each call, which costs a record's time again)."""
        try:
            ev = self.events.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        key = torch._C._cuda_getCurrentStream(self.device.index)
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        ev.record(stream)
        return ev

    def _anchor(self):
        """(host ns, CUDA event, device stamp ns) of one device moment.
        On an idle device an event `first` runs as the host records it;
        a spin holds the stream while the host queues the anchor's event,
        its stamp and an event `last`, which then run back to back
        (queued apart, the stamp would run a launch's host time after the
        event).  Where the host was slower than the spin (`last` more than
        20 us after the event), a longer spin tries again.  The host time
        is the host reading at `first` plus the device's time from `first`
        to the event."""
        for spin in (400_000, 4_000_000, 40_000_000):    # ~0.2, 2, 20 ms
            torch.cuda.synchronize(self.device)
            with torch.cuda.device(self.device):
                first, ev, last = (torch.cuda.Event(enable_timing=True)
                                   for _ in range(3))
                h = time.perf_counter_ns()
                first.record()
                torch.cuda._sleep(spin)
                ev.record()
                _launch_stamp(self.ring, self.device, 0)
                last.record()
                torch.cuda.synchronize(self.device)
            if ev.elapsed_time(last) < 0.02:
                break
        ring, n = self.ring
        stamp = int(ring[(int(n) - 1) % ring.shape[0], 0])
        return h + round(first.elapsed_time(ev) * 1e6), ev, stamp


class _Span:
    """A span being recorded (`span()` with tracing on)."""

    __slots__ = ("tracer", "name", "id", "rec", "rf")

    def __init__(self, tracer, name, id):
        self.tracer, self.name, self.id = tracer, name, id

    def __enter__(self):
        t = self.tracer
        stack = t.stack()
        parent = stack[-1] if stack else None
        sid = self.id
        if sid is None:
            sid = parent[3] if parent is not None else next(t.ids)
        self.rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        ev = (t.event() if t.device is not None
              and not torch.cuda.is_current_stream_capturing() else None)
        # name, seq, parent seq, id, thread, host start, end, events
        rec = [self.name, next(t.seqs),
               parent[1] if parent is not None else None, sid,
               threading.current_thread().name, time.perf_counter_ns(), 0,
               ev, None]
        stack.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        t, rec = self.tracer, self.rec
        if rec[7] is not None:
            rec[8] = t.event()
        rec[6] = time.perf_counter_ns()
        stack = t.stack()
        if stack and stack[-1] is rec:
            stack.pop()
        t.spans.append(rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _cuda(device):
    """`device` with its index (the current one where it has none), or
    None for a device that is not CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def enable_tracing(device=None):
    """Turn the tracer on, with nothing recorded yet.  `device`: the CUDA
    device whose work the spans' events and the programs' stamps time
    (None: the current one where there is one, else the host only)."""
    global _tracer
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    _tracer = _Tracer(_cuda(device))


def disable_tracing():
    """Turn the tracer off and drop what it holds."""
    global _tracer
    _tracer = None


def tracing() -> bool:
    """Whether the tracer is on."""
    return _tracer is not None


def span(name: str, id: Optional[int] = None):
    """A context that records the span `name` while tracing is on (the
    module docstring); the shared null context while it is off."""
    t = _tracer
    if t is None:
        return _NULL
    return _Span(t, name, id)


def count(name: str, n: int = 1):
    """Add `n` to the counter `name` while tracing is on."""
    t = _tracer
    if t is None:
        return
    with t.lock:
        t.counters[name] += n


def new_id() -> Optional[int]:
    """A fresh id for the spans of one request or tick (None while tracing
    is off)."""
    t = _tracer
    return next(t.ids) if t is not None else None


def add_span(name: str, start_ns: int, end_ns: int, id: int):
    """Record a finished host span measured by the caller (a request's
    stages, timed on several threads); nothing while tracing is off."""
    t = _tracer
    if t is None:
        return
    t.spans.append([name, next(t.seqs), None, id,
                    threading.current_thread().name, int(start_ns),
                    int(end_ns), None, None])


class Stamper:
    """The device stamps of one captured program.  `stamp(point, value)`
    queues the stamp kernel on the current stream (inside a capture: a
    kernel node of the graph); the tag holds the program's id, the point's
    code and `value` (an escalation step's index, the IPM's iterations).
    `watch(name, counter)`: a device counter of the program that
    `records()` reads under `name` (the escalation's total steps)."""

    def __init__(self, tracer, name):
        self.ring, self.device, self.name = tracer.ring, tracer.device, name
        self.id = next(_program_ids)
        self.counters = {}
        self.launched = 0
        _stampers.append(self)

    def stamp(self, point: str, value: int = 0):
        tag = (self.id << 32) | (_point(point) << 16) | (int(value) & 0xFFFF)
        _launch_stamp(self.ring, self.device, tag)
        self.launched += 1

    def watch(self, name, counter):
        self.counters[name] = counter


def stamper(name: str, device) -> Optional[Stamper]:
    """A `Stamper` for the program `name` on `device` while tracing is on
    with a ring there; else None (no stamp is captured)."""
    t = _tracer
    if t is None or t.device is None or _cuda(device) != t.device:
        return None
    return Stamper(t, name)


def records() -> dict:
    """Everything recorded since the last call (or `enable_tracing()`), on
    the host clock (ns of `time.perf_counter_ns()`), and forget it; {}
    while tracing is off.

    - `spans`: dicts of `name`, `seq` (its number), `parent` (the parent's
      seq, or None), `id`, `thread`, `host` [start, end] and `device`
      [start, end] (the events' times, or None);
    - `counters`: name -> count;
    - `stamps`: [host ns, program id, point, value], in device order;
      `dropped_stamps`: those the ring overwrote before this call;
    - `programs`: every captured program that stamps (`id`, `name`,
      `stamp_nodes`, and the device counters it watches, read here);
    - `device`: the CUDA device's name, or None."""
    t = _tracer
    if t is None:
        return {}
    spans, t.spans = t.spans, []
    with t.lock:
        counters, t.counters = dict(t.counters), collections.Counter()
    out = {"device": None, "counters": counters, "stamps": [],
           "dropped_stamps": 0, "programs": [], "spans": []}
    ev_map = None
    if t.device is not None:
        h0, e0, g0 = t.anchor
        t.anchor = h1, e1, g1 = t._anchor()
        out["device"] = torch.cuda.get_device_name(t.device)
        ev_scale = (h1 - h0) / (e0.elapsed_time(e1) * 1e6)
        g_scale = (h1 - h0) / (g1 - g0) if g1 != g0 else 1.0

        def ev_map(ev):
            return h0 + round(e0.elapsed_time(ev) * 1e6 * ev_scale)

        ring, n = t.ring
        total, cap = int(n), ring.shape[0]
        first = max(t.read, total - cap)
        out["dropped_stamps"] = first - t.read
        t.read = total
        if total > first:
            idx = torch.arange(first, total, device=ring.device) % cap
            rows = ring[idx].cpu().tolist()
            for g, tag in rows:
                pid, code = tag >> 32, (tag >> 16) & 0xFFFF
                if pid == 0:
                    continue            # an anchor
                out["stamps"].append([h0 + round((g - g0) * g_scale), pid,
                                      _point_names.get(code, str(code)),
                                      tag & 0xFFFF])
        out["programs"] = [
            dict(id=p.id, name=p.name, stamp_nodes=p.launched,
                 **{k: int(v) for k, v in p.counters.items()})
            for p in _stampers]
    for rec in spans:
        name, seq, parent, sid, thread, a, b, ea, eb = rec
        dev = None
        if ev_map is not None and ea is not None and eb is not None:
            dev = [ev_map(ea), ev_map(eb)]
            t.events += (ea, eb)
        out["spans"].append(dict(name=name, seq=seq, parent=parent, id=sid,
                                 thread=thread, host=[a, b], device=dev))
    return out
