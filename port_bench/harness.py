"""What every cell shares: the run's context, the measured window, the
device records, the profiler's reduction and the result line.

A runner (`runners/<kind>.py`, picked by the traffic file's `runner`)
runs one cell: set-up, then `ctx.open_window()`, the window's work, and
`ctx.close_window()`; it returns a `Result`.  `run.py` turns that into
the metrics of `BENCHMARK.json` and prints the line.
"""

import dataclasses
import json
import pathlib
import subprocess
import time
from typing import Dict, List, Tuple

import torch

ROOT = pathlib.Path(__file__).resolve().parent
CHECKOUT = ROOT.parent

# top-level module names that may not be loaded in a run's process: JAX,
# its companions, and the JAX package (compared whole: the port's name
# begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_collisionavoidance_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules):
    """The names in `modules` whose top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Result:
    """What a runner hands back.  `e2e`: end-to-end metrics by name (the
    harness adds `setup_s`); `checks`: (name, value, limit) of the numbers
    compared with the reference, `correct` iff every value <= its limit;
    `layer`: raw records the per-layer readers take their metrics from."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]
    layer: dict = dataclasses.field(default_factory=dict)


class Context:
    """One run of one cell: its files, its seed, its window."""

    def __init__(self, workload, seed, seconds, trace, t_start,
                 device="cuda", manifest=None):
        self.t_start = t_start
        self.manifest = manifest or load_json(CHECKOUT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the "
                             f"benchmark has {sorted(cells)}")
        self.cell = cells[workload]
        self.workload = workload
        self.config = load_json(ROOT / "configs" / f"{self.cell['config']}"
                                                  ".json")
        self.traffic = load_json(ROOT / "traffic" / f"{self.cell['traffic']}"
                                                    ".json")
        self.limits = load_json(ROOT / "limits" / f"{workload}.json")
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_open = self.t_close = None
        self.memory_peak_bytes = 0
        self.clocks = {}        # the cards' clocks at the window's ends
        self._clock_probe = None
        self.fault = None       # a test's planted fault: wraps a step
        self.max_ticks = None   # a test's window, in ticks
        self.solves = None      # the sampled solves, after the run

    # ---- the window ----
    def open_window(self):
        """Set-up ends: synchronise, take the time."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            # read while the window's first ticks run
            self._clock_probe = clock_probe()
        self.t_open = time.perf_counter()
        return self.t_open

    def remaining(self):
        return self.seconds - (time.perf_counter() - self.t_open)

    def over(self, ticks):
        """Whether the window has ended after `ticks` ticks."""
        if self.max_ticks is not None:
            return ticks >= self.max_ticks
        return self.remaining() <= 0

    def close_window(self):
        """Wait for the device, take the time and the peak memory (before
        any reference runs)."""
        self.sync()
        self.t_close = time.perf_counter()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
            self.clocks = {"open": clock_reading(self._clock_probe),
                           "close": clock_reading(clock_probe())}
        return self.t_close

    @property
    def setup_s(self):
        return self.t_open - self.t_start

    @property
    def window_s(self):
        return self.t_close - self.t_open

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def check(self, name, value):
        """(name, value, limit) of a compared number; a number that could
        not be read is infinite."""
        value = float(value)
        if value != value:
            value = float("inf")
        return (name, value, float(self.limits[name]["limit"]))


CLOCK_FIELDS = ("clocks.sm", "power.draw", "power.limit",
                "temperature.gpu", "clocks_throttle_reasons.active")


def clock_probe(fields=CLOCK_FIELDS):
    """Start a read-only `nvidia-smi` query of every card's SM clock (MHz),
    power draw and limit (W), temperature (C) and active clock-event
    reasons (a bit mask); None where it cannot start."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=" + ",".join(fields),
             "--format=csv,noheader,nounits"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def clock_reading(probe, fields=CLOCK_FIELDS):
    """A `clock_probe`'s answer: one list of `fields` per card, as
    `nvidia-smi` prints them; a driver that does not know the last field
    is asked again without it; None where there is no answer."""
    if probe is None:
        return None
    try:
        out, _ = probe.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        probe.kill()
        probe.communicate()
        return None
    if probe.returncode:
        return (clock_reading(clock_probe(fields[:-1]), fields[:-1])
                if len(fields) > 1 else None)
    return [[x.strip() for x in line.split(",")]
            for line in out.strip().splitlines()]


def is_correct(checks):
    """`correct`: every compared number within its limit (and some
    compared)."""
    return bool(checks) and all(v <= lim for _, v, lim in checks)


def dtype_of(config):
    return {"float32": torch.float32, "float64": torch.float64}[
        config["dtype"]]


class TickEvents:
    """CUDA events at each tick's first submission and after its last, on
    the current stream: the device's busy share between the first and the
    last (a tick's own gaps count as busy)."""

    def __init__(self, on):
        self.on = on
        self.pairs = []

    def begin(self):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs.append([e, None])

    def end(self):
        if self.on and self.pairs and self.pairs[-1][1] is None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs[-1][1] = e

    def busy_window_ms(self):
        """(busy ms, window ms) over the recorded ticks (synchronise
        first)."""
        pairs = [p for p in self.pairs if p[1] is not None]
        if len(pairs) < 2:
            return None
        busy = sum(a.elapsed_time(b) for a, b in pairs)
        return busy, pairs[0][0].elapsed_time(pairs[-1][1])


class EventTimer:
    """CUDA events around each call of a device program: its device time,
    ms per call."""

    def __init__(self):
        self.pairs = []

    def __enter__(self):
        self._a = torch.cuda.Event(enable_timing=True)
        self._a.record()
        return self

    def __exit__(self, *exc):
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        self.pairs.append((self._a, b))

    def ms(self):
        return [a.elapsed_time(b) for a, b in self.pairs]


def profile_kernels(prof):
    """Device kernels of a finished `torch.profiler.profile`: a list of
    (name, start us, end us), ordered by start."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, float(e.time_range.start),
                        float(e.time_range.end)))
    out.sort(key=lambda k: k[1])
    return out


def kernel_summary(kernels):
    """(busy s, traced window s, breakdown) of the profiler's kernels: the
    union of their intervals, first start to last end, the ten kernels
    that took most time, and the ten longest idle gaps named by the
    kernels on either side."""
    if not kernels:
        return None
    busy, cur_s, cur_e = 0.0, None, None
    gaps = []
    last = None
    for name, s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, f"after {last[:60]} before "
                                        f"{name[:60]}"))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = name
    busy += cur_e - cur_s
    window = max(e for _, _, e in kernels) - kernels[0][1]
    by_name = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(key=lambda g: -g[0])
    return (busy * 1e-6, window * 1e-6, {
        "device_ops": [[n[:200], t * 1e-6] for n, t in ops],
        "idle_gaps": [[n, g * 1e-6] for g, n in gaps[:10]]})


class Profiled:
    """torch.profiler over a stretch of the traced run; `kernels` after
    the block."""

    def __init__(self, on):
        self.on = on
        self.kernels = []

    def __enter__(self):
        if self.on:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            self.kernels = profile_kernels(self.prof)
            del self.prof
