"""One run of one cell with the program's own tracer on: the readings of
the spans and device stamps inside the port, beside the benchmark's own.

    python3 -m port_bench.program_trace --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> [--out <file>]

The run is `port_bench.run`'s, with three additions.  Before the runner,
`enable_tracing()` (`utils/profiling.py`), so the captured ticks stamp
the device; as the window opens the trace of the set-up is dropped, and
as it closes the window's trace is taken (`records()`).  The printed line
then also carries, under `metrics`, each reading of `metrics/` that reads
the program's trace (`guidance_host_ms`, `guidance_device_ms`,
`lane_fixed_ms`, `esc_step_ms`, `instance_qp_ms`,
`instance_ipm_iter_ms`) that finds something to read; under `breakdown`,
`host_gaps` (`metrics/_trace.py::host_gaps`); and `program_trace`: the
trace's counts, the stamps' clock held to the launch events', the lane
and node readings against the outside ones, and the ticks profiled after
the window against their stamps.  The spans' `record_function` ranges
in that profiled stretch are left out of its `busy_s` and `breakdown`,
which count kernels.  `--out` writes the window's trace as JSON.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

PROGRAM_METRICS = ("guidance_host_ms", "guidance_device_ms", "lane_fixed_ms",
                   "esc_step_ms", "instance_qp_ms", "instance_ipm_iter_ms")


def _program(trace):
    """The captured program whose ticks the cell's trace stamps."""
    names = {p["name"] for p in trace["programs"]}
    return "lane.step" if "lane.step" in names else "instance.step"


def extend(line, layer, trace, profiled, timed=None):
    """Add the program trace's readings to `line` (module docstring);
    `profiled`: `_trace.profiled_vs_stamps` of the ticks profiled after
    the window; `timed`: how many of the window's first ticks the runner
    timed with its CUDA events (None: all)."""
    from port_bench.metrics import _trace
    from port_bench.run import _metric_reader
    rec = dict(layer, program_trace=trace)
    metrics = line["metrics"]
    for name in PROGRAM_METRICS:
        v = _metric_reader(name)(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": "ms"}
    gaps = _trace.host_gaps(trace)
    if gaps is not None:
        line.setdefault("breakdown", {})["host_gaps"] = gaps
    program = _program(trace)
    checked, bad, worst = _trace.clock_violations(trace, program)
    info = dict(spans=len(trace["spans"]), stamps=len(trace["stamps"]),
                dropped_stamps=trace["dropped_stamps"],
                counters=trace["counters"], programs=trace["programs"],
                one_clock=dict(program=program, ticks=checked,
                               violations=bad, worst_us=worst * 1e-3),
                profiled=profiled)

    def value(name):
        return metrics.get(name, {}).get("value")

    # the stamps of the ticks that `lane_tick_ms` and `esc_iters_per_tick`
    # cover (the first `timed`; None: all), held to them
    tick, iters = value("lane_tick_ms"), value("esc_iters_per_tick")
    tk = _trace.ticks(trace, "lane.step")[:timed]
    if tk and None not in (tick, iters):
        steps = [b - a for t in tk for a, b in _trace.esc_steps(t)]
        fixed = _trace.MS * (sum(t["end"] - t["start"] for t in tk)
                             - sum(steps)) / len(tk)
        step = _trace.MS * sum(steps) / len(steps) if steps else 0.0
        info["lane_timed"] = dict(
            ticks=len(tk), fixed_ms=fixed, esc_step_ms=step,
            esc_steps_stamped=len(steps) / len(tk),
            sum_over_tick=(fixed + iters * step) / tick)
    if program == "instance.step":
        info["instance_split_ms"] = _trace.instance_split(trace)
    line["program_trace"] = info


def run_cell(ctx):
    """Run the cell of `ctx` with the tracer on (`enable_tracing()` before
    the solver is built), the set-up's trace dropped as the window opens
    and the window's taken as it closes; returns the extended line and the
    window's trace."""
    from mpc_collisionavoidance_tpu_torch.utils import profiling
    from port_bench.harness import kernel_summary
    from port_bench.metrics import _trace
    from port_bench.run import assemble
    window = {}
    open_window, close_window = ctx.open_window, ctx.close_window

    def opened():
        profiling.records()            # drop the set-up's trace
        return open_window()

    def closed():
        t = close_window()
        window["trace"] = profiling.records()
        return t

    ctx.open_window, ctx.close_window = opened, closed
    runner = importlib.import_module(
        f"port_bench.runners.{ctx.traffic['runner']}")
    res = runner.run(ctx)
    after, layer = profiling.records(), res.layer
    profiled = _trace.profiled_vs_stamps(layer.get("kernels"), after,
                                         _program(window["trace"]))
    # the spans' `record_function` ranges are device events of the
    # profiled stretch: `busy_s` and the breakdown count the kernels only
    if layer.get("kernels"):
        names = {s["name"] for s in after.get("spans", ())}
        layer["kernels"] = [k for k in layer["kernels"] if k[0] not in names]
        layer["profile_summary"] = kernel_summary(layer["kernels"])
    line = assemble(ctx, res)
    extend(line, layer, window["trace"], profiled,
           ctx.traffic.get("trace", {}).get("event_ticks"))
    return line, window["trace"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from mpc_collisionavoidance_tpu_torch.utils import profiling
    from port_bench.harness import (Context, ROOT, forbidden_modules,
                                    load_json)
    manifest = load_json(ROOT.parent / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(
        args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); this "
              f"host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    profiling.enable_tracing("cuda")
    ctx = Context(args.workload, args.seed, args.seconds, args.trace,
                  T_START, device="cuda", manifest=manifest)
    line, trace = run_cell(ctx)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(trace, f)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"port_bench: modules that may not load in a run: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
