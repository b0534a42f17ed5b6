"""The readings that the limits of `correct` are set from: for each seed, a
run of the cell as the benchmark runs it (the program's readings of every
compared number), and on the control seeds, the control's readings of
the same sampled ticks (the reference, with its linearization and the
guidance rounded to TF32, in the program's place), held to the same
limits.  The benchmark's own runs never run the control.

    python3 -m port_bench.control --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 10 [--out file.jsonl]

One JSON line per seed on standard output (and appended to `--out`).
Exits 1 where the control comes out correct on some seed: the limits
then do not tell the program from its lower precision.
"""

import argparse
import importlib
import json
import sys
import time

from port_bench.harness import is_correct


def control_checks(ctx):
    """The control's readings of the run's sampled solves (`ctx.solves`,
    and the fleet's sampled guidance, `ctx.guidance`), each beside the
    cell's limit, as `ctx.check` gives them."""
    from port_bench.reference import guidance
    from port_bench.runners import common
    r = common.judge(ctx.config["ocp"], ctx.solves, ctx.device,
                     control=True)
    checks = [ctx.check("feas", r["feas"]),
              ctx.check("cost_gap", r["cost_gap"])]
    if getattr(ctx, "guidance", None):
        g = [guidance.readings(a, b, control=True) for a, b in ctx.guidance]
        checks += [ctx.check(k, max(x[k] for x in g))
                   for k in ("guidance", "plant")]
    return checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from port_bench.harness import Context
    from port_bench.runners import common
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    control = {int(s) for s in args.control_seeds.split(",") if s}
    control_passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(args.workload, seed, args.seconds, 0, t0)
        runner = importlib.import_module(
            f"port_bench.runners.{ctx.traffic['runner']}")
        res = runner.run(ctx)
        line = {"workload": args.workload, "seed": seed,
                "setup_s": ctx.setup_s, "e2e": res.e2e,
                "correct": is_correct(res.checks),
                "program": {n: v for n, v, _ in res.checks},
                "judged": res.layer.get("judged"),
                "attempted": res.attempted, "failed": res.failed,
                "clocks": ctx.clocks}
        if seed in control:
            checks = control_checks(ctx)
            line["control"] = {n: v for n, v, _ in checks}
            line["control_correct"] = is_correct(checks)
            if line["control_correct"]:
                control_passed.append(seed)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del ctx, res
        common.free_device()
    if control_passed:
        print(f"port_bench.control: the control came out correct on seeds "
              f"{control_passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
