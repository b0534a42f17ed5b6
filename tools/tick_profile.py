"""Where a tick's time goes on the card, per OCP, backend and batch: the
captured tick (the main path) beside the eager one.

    python -m tools.tick_profile [--ticks 20] [--profiled 10]
                                 [--only NAME ...] [--json PATH]

For every OCP the port runs on the card (the flagship, the hull, the
hull family, the guidance family and the race car's runs
`chip_smoke.RACE`: race_cars and race_cars_dev on the curved track,
race_cars on the straight one), the production (sweep) and the fused
tick, at B=512 and B=1 (float32, the warm closed loop of `chip_smoke`'s
workload, x0 <- x1), in one process:

- the eager tick (`capture=False`, op by op): the median and p99 tick
  over `--ticks` warm ticks (CUDA events around the whole tick) and the
  escalation iterations per tick, then a torch.profiler window over
  `--profiled` more ticks: device kernel time per tick and its share of
  the window's wall time (busy, a lower bound: the profiler stretches the
  window), kernels and launch calls per tick, and the three kernels with
  the most device time per tick with their launches per tick;
- the captured tick (one graph launch): the same median, p99 and
  escalation per tick, its graph's nodes and conditional nodes, capture
  and instantiation times and pool memory, then `--profiled` more timed
  ticks.  Those run the kernels of the eager loop's profiled window (the
  two loops are bitwise equal, `chip_smoke.py` phase 15, and both report
  the window's escalation iterations), so its busy share is that window's
  kernel time over the same ticks' time here.  It is not profiled here,
  though torch.profiler does report a captured tick's kernels, those
  inside its conditional nodes too (K1's profiled launches of a captured
  hull lane tick are its 4 fixed ones plus one per escalation step that
  ran, as the tracer's device stamps count them).

With --json, one JSON line per configuration and mode goes to PATH as it
is measured.  Needs a CUDA device.
"""

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from mpc_collisionavoidance_tpu_torch.kernels import _build

CONFIGS = [(name, backend, Bn)
           for name in (chip_smoke.FLAGSHIP, chip_smoke.HULL,
                        *chip_smoke.FAMILY, *chip_smoke.GUIDANCE,
                        *chip_smoke.RACE)
           for backend in ("sweep", "fused") for Bn in (512, 1)]


def _loop(name, backend, Bn, ticks, capture):
    """A warm closed loop of `ticks` timed ticks: (solver, its state and
    inputs, tick times in ms, escalation iterations per tick)."""
    config = (chip_smoke._production() if backend == "sweep"
              else chip_smoke._fused())
    solver, st, x, p, lh, refs = chip_smoke._setup(
        name, Bn, torch.float32, chip_smoke.DEVICE, config, capture=capture)
    for _ in range(3):                                  # warm-up
        st, out = solver.step_fn(st, x, p, lh, **refs)
        x = out.x1
    times, esc = [], []
    for _ in range(ticks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = solver.step_fn(st, x, p, lh, **refs)
        end.record()
        x = out.x1
        end.synchronize()
        times.append(start.elapsed_time(end))
        esc.append(int(solver.last_esc_iters))
    return solver, (st, x, p, lh, refs), times, esc


def _row(name, backend, Bn, mode, times, esc, window_esc):
    return dict(ocp=name, backend=backend, B=Bn, mode=mode,
                tick_median_ms=float(np.median(times)),
                tick_p99_ms=float(np.percentile(times, 99)),
                esc_iters_per_tick=float(np.mean(esc)),
                window_esc_iters=int(sum(window_esc)))


def profile_eager(name, backend, Bn, ticks, profiled):
    solver, (st, x, p, lh, refs), times, esc = _loop(name, backend, Bn,
                                                     ticks, capture=False)
    torch.cuda.synchronize()
    window_esc = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            st, out = solver.step_fn(st, x, p, lh, **refs)
            x = out.x1
            window_esc.append(int(solver.last_esc_iters))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    calls = 0
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            calls += "LaunchKernel" in e.name
        elif not e.name.startswith(("Memcpy", "Memset")):
            per_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3
            per_kernel[e.name][1] += 1
    kernel_ms = sum(v[0] for v in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:3]
    return dict(
        _row(name, backend, Bn, "eager", times, esc, window_esc),
        kernel_ms_per_tick=kernel_ms / profiled,
        busy_share=kernel_ms / wall_ms,
        kernels_per_tick=sum(v[1] for v in per_kernel.values()) / profiled,
        launch_calls_per_tick=calls / profiled,
        top=[dict(kernel=k[:80], ms_per_tick=v[0] / profiled,
                  launches_per_tick=v[1] / profiled) for k, v in top])


def time_captured(name, backend, Bn, ticks, profiled, kernel_ms):
    """The captured loop; `kernel_ms` per tick of the eager loop's
    profiled window, which this loop's last `profiled` ticks repeat."""
    solver, _, times, esc = _loop(name, backend, Bn, ticks + profiled,
                                  capture=True)
    (program,) = solver._graphs.programs.values()
    row = _row(name, backend, Bn, "captured", times[:ticks], esc[:ticks],
               esc[ticks:])
    return dict(row, kernel_ms_per_tick=kernel_ms,
                busy_share=kernel_ms * profiled / sum(times[ticks:]),
                nodes=program.nodes, conditional=program.conditional,
                capture_s=program.capture_s,
                instantiate_s=program.instantiate_s,
                pool_mib=program.pool_bytes / 2**20)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--profiled", type=int, default=10)
    ap.add_argument("--only", nargs="*", default=None,
                    help="these OCPs only (names of builders.BUILDERS, "
                         "or of chip_smoke.RACE)")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tick_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    _build.library()
    out = None
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("")
    for name, backend, Bn in CONFIGS:
        if args.only and name not in args.only:
            continue
        eager = dict(profile_eager(name, backend, Bn, args.ticks,
                                   args.profiled), card=card)
        captured = dict(time_captured(name, backend, Bn, args.ticks,
                                      args.profiled,
                                      eager["kernel_ms_per_tick"]),
                        card=card)
        for r in (captured, eager):
            graph = (f"; graph {r['nodes']} nodes ({r['conditional']} "
                     f"conditional), capture {r['capture_s']:.3f} s, "
                     f"instantiate {r['instantiate_s']:.3f} s, pool "
                     f"{r['pool_mib']:.1f} MiB" if "nodes" in r else
                     f", {r['kernels_per_tick']:.1f} kernels / "
                     f"{r['launch_calls_per_tick']:.1f} launch calls per "
                     "tick; " + "; ".join(
                         f"{t['kernel'][:40]} {t['ms_per_tick']:.3f} ms "
                         f"x{t['launches_per_tick']:.1f}" for t in r["top"]))
            print(f"{name} {backend} B={Bn} {r['mode']}: tick median "
                  f"{r['tick_median_ms']:.3f} ms (p99 "
                  f"{r['tick_p99_ms']:.3f}), escalation "
                  f"{r['esc_iters_per_tick']:.2f} per tick "
                  f"({r['window_esc_iters']} in the window), kernels "
                  f"{r['kernel_ms_per_tick']:.3f} ms/tick (busy "
                  f"{100 * r['busy_share']:.1f}%){graph}", flush=True)
            if out is not None:
                with out.open("a") as f:
                    f.write(json.dumps(r) + "\n")
    if out is not None:
        print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
