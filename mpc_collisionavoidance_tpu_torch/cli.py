"""Experiment runner CLI — the reference's `python main.py` experience
(counterpart of `mpc_collisionavoidance_tpu/cli.py`).

The reference runs one closed-loop experiment per variant directory,
printing avg/max solve time and MSE/MAE tracking errors and popping
matplotlib windows (reference scripts/usv_guidance_ca1/main.py:189-205).
Here one command runs any variant at any horizon from a JSON config or
flags, prints the same metrics as structured JSON, and saves the
dashboard PNGs:

    python -m mpc_collisionavoidance_tpu_torch run --model usv_guidance_ca1 \\
        --steps 1000 --plots /tmp/flagship
    python -m mpc_collisionavoidance_tpu_torch run --config exp.json
    python -m mpc_collisionavoidance_tpu_torch race
    python -m mpc_collisionavoidance_tpu_torch mission --markers m.jsonl
    python -m mpc_collisionavoidance_tpu_torch models   # list the zoo

The commands take the JAX package's flags, defaults and JSON keys, except
that `--platform` is `--device`: "cuda" by default, where a host with no
CUDA device is an error; "cpu" runs the kernels' plain versions.  The
experiment JSON is shared with the JAX package (`config.py`).  Each run is
a Python loop over ticks: on the card each tick, on either engine, is one
captured CUDA graph (`--eager`: op by op, for comparisons), where the JAX
package jits the whole loop.  `--plots` and `--gif` need matplotlib.
The JAX package's `bench` command runs its `bench.py`, which imports jax:
the port has no such command yet.
"""

import argparse
import inspect
import json
import sys

import numpy as np
import torch


def _cmd_models(_args):
    from mpc_collisionavoidance_tpu_torch.models import registry
    for name in registry.names():
        m = registry.get(name)
        print(f"{name:22s} nx={m.nx:2d} nu={m.nu} nh={m.nh} np={m.np_}")
    return 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# each variant's reference experiment (the role of the per-variant
# scripts/<v>/main.py): (scenario factory name, (heading-err idx,
# cross-track idx))
RUN_SCENARIOS = {
    "usv_guidance_ca1": ("guidance_ca1_default", (3, 2)),
    "usv_guidance_ca": ("guidance_ca_default", (3, 2)),
    "usv_pf_ca": ("pf_ca_default", (0, 6)),
    "usv_pf": ("pf_default", (0, 6)),
    "usv_acados": ("acados_speed_default", (0, 0)),
    "usv_low_level": ("low_level_default", (0, 3)),
    "usv_position_control": ("position_control_default", (0, 1)),
    "usv_guidance": ("guidance_default", (2, 7)),
    "usv_guidance2": ("guidance2_default", (2, 8)),
    "usv_guidance3": ("guidance3_default", (2, 8)),
    "usv_guidance4": ("guidance4_default", (3, 2)),
    "usv_guidance5": ("guidance5_default", (3, 2)),
}


def _cmd_run(args):
    from mpc_collisionavoidance_tpu_torch.config import (
        FrameworkConfig, production_engine, require_device)
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    from mpc_collisionavoidance_tpu_torch.sim.closed_loop import (
        run_closed_loop)
    from mpc_collisionavoidance_tpu_torch.utils.profiling import SolveTimer

    device = require_device(args.device)
    if args.config:
        with open(args.config) as f:
            cfg = FrameworkConfig.from_dict(json.load(f))
    else:
        # unset -N/--tf fall back to the variant's own reference defaults
        # (builders encode the SURVEY.md 2.4 (Tf, N) per variant)
        from mpc_collisionavoidance_tpu_torch.ocp import builders as _b
        N, Tf = args.N, args.tf
        if args.model in _b.BUILDERS:   # unknown names fall through to
            sig = inspect.signature(_b.BUILDERS[args.model])  # config's
            if N is None:                                      # error
                N = sig.parameters["N"].default
            if Tf is None:
                Tf = sig.parameters["Tf"].default
        # no config file -> the single production preset (the same engine
        # the RT server defaults to; config.py)
        cfg = FrameworkConfig(model=args.model, N=N or 100, Tf=Tf or 5.0,
                              solver=production_engine())

    spec = cfg.build_spec()
    if cfg.solver.engine == "lane":
        # production lane engine behind the instance-shaped facade; the
        # lane path is float32 (the serving dtype)
        from mpc_collisionavoidance_tpu_torch.solver.batch import (
            LaneSolverAdapter)
        run_dtype = torch.float32
        solver = LaneSolverAdapter(cfg.build_solver(
            device=device, dtype=run_dtype, capture=not args.eager))
    else:
        run_dtype = torch.float64
        solver = cfg.build_solver(device=device, dtype=run_dtype,
                                  capture=not args.eager)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=run_dtype, device=device)

    m = spec.model
    yref = yref_e = None
    if cfg.model in RUN_SCENARIOS:
        factory, err_idx = RUN_SCENARIOS[cfg.model]
        sc = getattr(scenarios, factory)()
        x0 = sc.x0
        params = (np.asarray(sc.params) if np.size(sc.params)
                  else np.zeros((m.np_,)))
        lh = t(sc.lh) if np.size(sc.lh) else None
        if sc.yref is not None:
            if cfg.solver.engine == "lane":
                # the lane engine broadcasts ONE stage reference (ny,)
                yref = t(sc.yref)
            else:
                yref = t(np.tile(np.asarray(sc.yref), (spec.N, 1)))
            yref_e = t(sc.yref_e)
    else:
        x0 = m.x0
        params = (np.full((m.np_,), 100.0) if m.np_ else np.zeros((0,)))
        lh = None
        err_idx = (0, 1) if m.nx >= 2 else (0, 0)

    transient = min(400, args.steps // 2)

    def run():
        return run_closed_loop(
            solver, x0, params, lh, n_steps=args.steps, err_idx=err_idx,
            yref=yref, yref_e=yref_e, transient=transient,
            metric_norm=max(args.steps - transient, 1))

    timer = SolveTimer(batch=args.steps)
    with timer.tick():   # kernel load + graph capture + full run
        res = run()
        _sync(device)
    with timer.tick():   # steady-state rerun
        res = run()
        _sync(device)

    simX = res.simX.cpu().numpy()
    status = res.status.cpu().numpy()
    sv = cfg.solver
    out = {
        "model": cfg.model, "N": cfg.N, "Tf": cfg.Tf, "steps": args.steps,
        "engine": sv.engine,
        "schedule": f"{sv.centering}@{sv.ipm_iters}"
                    + (f"+esc{sv.extra_iters}" if sv.extra_iters else ""),
        "psi_mae": float(res.psi_mae), "ye_mae": float(res.ye_mae),
        "psi_mse": float(res.psi_mse), "ye_mse": float(res.ye_mse),
        "status_ok_rate": float(np.mean(status == 0)),
        "finite": bool(np.all(np.isfinite(simX))),
        "compile_plus_run_s": round(timer.samples[0], 3),
        "steady_run_s": round(timer.samples[1], 3),
        "solves_per_s_closed_loop": round(args.steps / timer.samples[1], 1),
    }
    print(json.dumps(out))

    if args.plots:
        from mpc_collisionavoidance_tpu_torch.utils import plotting
        simU = res.simU.cpu().numpy()
        if cfg.model == "usv_guidance_ca1":
            obstacles = np.asarray(params).reshape(-1, 2)[:4]
            radii = lh.cpu().numpy()[:4]
            plotting.plot_flagship(simX, simU, spec.dt, obstacles, radii,
                                   save_path=args.plots)
            print(f"plots: {args.plots}_timeseries.png, {args.plots}_xy.png",
                  file=sys.stderr)
        elif cfg.model in ("usv_pf", "usv_pf_ca"):
            if cfg.model == "usv_pf_ca":
                obstacles = np.asarray(params).reshape(-1, 2)
                radii = lh.cpu().numpy()
            else:
                obstacles = radii = None
            plotting.plot_pf_family(simX, simU, spec.dt, obstacles, radii,
                                    save_path=args.plots)
            print(f"plots: {args.plots}_{{timeseries,xy,errors}}.png",
                  file=sys.stderr)
    return 0 if out["finite"] else 1


def _cmd_race(args):
    from mpc_collisionavoidance_tpu_torch.config import require_device
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim.closed_loop import (
        run_closed_loop)
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver
    from mpc_collisionavoidance_tpu_torch.utils import track as trk

    device = require_device(args.device)
    f64 = dict(dtype=torch.float64, device=device)
    tr = trk.make_synthetic_track()
    spec = builders.build("race_cars", track=tr)
    m = spec.model
    solver = RTISolver(spec, ipm_iters=18, **f64, capture=not args.eager)
    ny, nx, N = spec.cost.ny, m.nx, spec.N
    ramp_unit = 3.0 * torch.arange(N, **f64) / N

    def yref_fn(x, k):
        # the reference's receding progress reference: s ramps from the
        # current s0 to s0 + 3 across the horizon (race_cars/main.py:74-83)
        s0 = x[0]
        yref = torch.zeros((N, ny), **f64)
        yref[:, 0] = s0 + ramp_unit
        yref_e = torch.zeros(nx, **f64)
        yref_e[0] = s0 + 3.0
        return yref, yref_e

    res = run_closed_loop(solver, m.x0, torch.zeros(0, **f64),
                          n_steps=args.steps, yref_fn=yref_fn)
    simX = res.simX.cpu().numpy()
    status = res.status.cpu().numpy()
    out = {
        "track_length_m": round(tr.length, 3),
        "steps": args.steps,
        "s_final": round(float(simX[-1, 0]), 3),
        "laps": round(float(simX[-1, 0]) / tr.length, 2),
        "v_max": round(float(np.max(simX[:, 3])), 3),
        "n_abs_max": round(float(np.max(np.abs(simX[:, 1]))), 4),
        "status_ok_rate": float(np.mean(status == 0)),
        "finite": bool(np.all(np.isfinite(simX))),
    }
    print(json.dumps(out))
    if args.plots:
        from mpc_collisionavoidance_tpu_torch.utils import plotting
        plotting.plot_race_track(tr, simX, save_path=args.plots)
        print(f"plot: {args.plots}_track.png", file=sys.stderr)
    return 0 if out["finite"] else 1


def _cmd_mission(args):
    """Full flagship mission (waypoints + fake LiDAR field) with the
    live-safety-marker outputs: JSONL stream and/or animated GIF — the
    reference's rviz obstacle/safety-band visualization
    (src/nmpc_guidance_ca1.cpp:378-414)."""
    from mpc_collisionavoidance_tpu_torch.config import (production_engine,
                                                         require_device)
    from mpc_collisionavoidance_tpu_torch.guidance import (
        GuidanceController, Measurements)
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.sim import mission, scenarios
    from mpc_collisionavoidance_tpu_torch.solver.batch import (
        LaneSolverAdapter)
    from mpc_collisionavoidance_tpu_torch.utils import viz

    device = require_device(args.device)
    # missions ride the same production engine as the server (the lane
    # engine behind the instance-shaped adapter, float32; config.py)
    spec = builders.usv_guidance_ca1()
    lane = production_engine().build(spec, device=device,
                                      dtype=torch.float32)
    ctrl = GuidanceController(spec, solver=LaneSolverAdapter(lane))
    if args.challenge == 1:
        # the AutonomousNavigation course through the 21-buoy field
        wps, n_wp, field, valid = scenarios.autonav_mission()
        meas0 = Measurements(u=0.7, v=0.0, nedx=0.0, nedy=0.0, psi=0.0)
    else:
        # challenge 0: the straight two-leg line through the 4 big buoys
        field, valid = scenarios.challenge0_field()
        wps = np.array([[4.0, -5.0], [4.0, 25.0]])
        n_wp = 2
        meas0 = Measurements(u=0.7, v=0.0, nedx=4.0, nedy=-5.0,
                             psi=np.pi / 2)
    log = mission.run_mission(ctrl, meas0, wps, n_wp, field, valid,
                              n_steps=args.steps)

    frames = viz.frames_from_mission(log, field, valid,
                                     stride=args.stride)
    n_coll = sum(f.collision for f in frames)
    print(json.dumps({"ticks": args.steps, "frames": len(frames),
                      "collisions": int(n_coll),
                      "final_pos": [round(float(v), 3)
                                    for v in log.pos[-1].cpu()]}))
    if args.markers:
        viz.write_jsonl(frames, args.markers)
        print(f"marker stream -> {args.markers}")
    if args.gif:
        viz.render_animation(frames, args.gif, fps=args.fps)
        print(f"animation -> {args.gif}")
    return 0


def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; a host without CUDA "
                        "is an error) or cpu (the kernels' plain versions)")


def _eager_flag(p):
    p.add_argument("--eager", action="store_true",
                   help="run each tick op by op instead of replaying its "
                        "captured CUDA graph (for comparisons)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mpc_collisionavoidance_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="closed-loop experiment")
    p_run.add_argument("--config", help="FrameworkConfig JSON file")
    p_run.add_argument("--model", default="usv_guidance_ca1")
    p_run.add_argument("-N", type=int, default=None,
                       help="horizon stages (default: the variant's "
                            "reference value)")
    p_run.add_argument("--tf", type=float, default=None,
                       help="horizon length [s] (default: the variant's "
                            "reference value)")
    p_run.add_argument("--steps", type=int, default=1000)
    p_run.add_argument("--plots", help="save dashboards to this path prefix")
    _device_flag(p_run)
    _eager_flag(p_run)
    p_run.set_defaults(fn=_cmd_run)

    p_race = sub.add_parser(
        "race", help="race the synthetic closed track (curved-kappa "
                     "race_cars with the receding progress reference)")
    p_race.add_argument("--steps", type=int, default=700)
    p_race.add_argument("--plots", help="save the track plot to this prefix")
    _device_flag(p_race)
    _eager_flag(p_race)
    p_race.set_defaults(fn=_cmd_race)

    p_mis = sub.add_parser(
        "mission", help="flagship mission with live safety markers "
                        "(JSONL stream / GIF) — the rviz-marker role")
    p_mis.add_argument("--steps", type=int, default=600)
    p_mis.add_argument("--challenge", type=int, default=0, choices=(0, 1))
    p_mis.add_argument("--stride", type=int, default=2,
                       help="render every k-th tick")
    p_mis.add_argument("--markers", help="write the JSONL marker stream here")
    p_mis.add_argument("--gif", help="render an animated GIF here")
    p_mis.add_argument("--fps", type=int, default=20)
    _device_flag(p_mis)
    p_mis.set_defaults(fn=_cmd_mission)

    p_models = sub.add_parser("models", help="list the model zoo")
    p_models.set_defaults(fn=_cmd_models)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
