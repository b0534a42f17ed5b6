"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<traffic>.json`), whose `runner` picks the general code that
runs it (`runners/<runner>.py`); the cell's limits are
`limits/<workload>.json` and each per-layer metric is read by
`metrics/<metric>.py`.  With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer ones.  A host without
the CUDA devices the cell asks for exits 2 and prints no result; so does a
run in whose process JAX or the JAX package was loaded (exit 3).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _metric_reader(name):
    from port_bench.harness import ROOT
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric, cell_name, e2e_names):
    """Whether `metric` is reported in the cell: its `workloads`, else
    (a per-layer metric) every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def assemble(ctx, res):
    """The result line's dict, and the compared numbers' lines."""
    import torch

    from port_bench.harness import is_correct
    man, cell = ctx.manifest, ctx.cell["name"]
    e2e = [m for m in man["end_to_end"] if applies(m, cell, ())]
    e2e_names = {m["name"] for m in e2e}
    values = dict(res.e2e, setup_s=ctx.setup_s)
    metrics = {}
    if not ctx.trace:
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in man["per_layer"]:
            if not applies(m, cell, e2e_names):
                continue
            v = _metric_reader(m["name"])(res.layer)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(ctx.device),
              "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    summary = res.layer.get("profile_summary")
    if ctx.trace and summary is not None:
        device["busy_s"], device["window_s"] = summary[0], summary[1]
    correct = is_correct(res.checks)
    line = {"correct": correct, "attempted": int(res.attempted),
            "failed": int(res.failed), "metrics": metrics, "device": device}
    if ctx.trace and summary is not None:
        line["breakdown"] = summary[2]
    line["clocks"] = ctx.clocks
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in res.checks}
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench.harness import (CLOCK_FIELDS, Context, ROOT,
                                    forbidden_modules, load_json)
    manifest = load_json(ROOT.parent / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}.get(
        args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); this "
              f"host has {torch.cuda.device_count()} (available: "
              f"{torch.cuda.is_available()})", file=sys.stderr)
        return 2
    ctx = Context(args.workload, args.seed, args.seconds, args.trace,
                  T_START, device="cuda", manifest=manifest)
    runner = importlib.import_module(
        f"port_bench.runners.{ctx.traffic['runner']}")
    res = runner.run(ctx)
    line = assemble(ctx, res)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"port_bench: modules that may not load in a run: {bad}",
              file=sys.stderr)
        return 3
    for end, cards in line["clocks"].items():
        print(f"clocks at the window's {end} ({', '.join(CLOCK_FIELDS)}): "
              f"{cards}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
