"""Tracing / profiling utilities (counterpart of
`mpc_collisionavoidance_tpu/utils/profiling.py`).

The reference's only instrumentation is wall-clock around each solve with
a running sum/max printed at exit (reference
scripts/usv_guidance_ca1/main.py:133-144,197-198).  `SolveTimer` keeps that
exact surface (avg/max, plus percentiles and solves/s) on the host clock:
CUDA work is asynchronous, so a caller synchronizes the device inside
`tick()` (`torch.cuda.synchronize()`, as the JAX package's callers call
`block_until_ready`).  `trace` wraps `torch.profiler` for per-kernel
timelines, and `device_memory_stats` reads the card's allocator.
"""

import contextlib
import os
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

    Kernels launched inside a conditional node of a captured CUDA graph
    (the captured lane tick's escalation steps, `solver/capture.py`) do
    not show up in it: profile such ticks eagerly (`capture=False`)."""
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
