"""Multi-device validation of the scenario-parallel layer (the port's
counterpart of `__graft_entry__.py::dryrun_multichip`) and its launcher.

    python -m mpc_collisionavoidance_tpu_torch.parallel.dryrun --ranks N \\
        [--device cuda|cpu] [--timeout S] [--N --tf --lanes]

starts N ranks on this host through torchrun (rank r on `cuda:r` with
NCCL, or on the CPU with gloo); each runs `dryrun_multichip` on its shard
and prints its metrics, which are collectives and so must be equal on
every rank.  The launcher exits non-zero if a rank fails, the ranks
disagree, or the run outlasts `--timeout` (every rank's process group
times out within it too, so no rank waits for ever in a collective).
NCCL needs one GPU per rank.  `--N`, `--tf` and `--lanes` shrink the
flagship shape for a CPU run.
"""

import argparse
import datetime
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from mpc_collisionavoidance_tpu_torch.guidance.controller import Measurements
from mpc_collisionavoidance_tpu_torch.ocp import builders
from mpc_collisionavoidance_tpu_torch.parallel import distributed
from mpc_collisionavoidance_tpu_torch.parallel.sharding import (
    fleet_metrics, make_mesh, make_sharded_batch_solver, shard_batch,
    shard_lanes)
from mpc_collisionavoidance_tpu_torch.sim import scenarios
from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetMissionEngine
from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                           to_lanes)
from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver

# JAX's dryrun settings: the flagship at the reference's shape (N=100,
# Tf=5, 10 IPM iterations, scripts/usv_guidance_ca1/main.py:54-55), 3
# closed-loop ticks, a 30-tick mission, float32
IPM_ITERS, TICKS, MISSION_TICKS = 10, 3, 30
DTYPE = torch.float32


def _reduce(mesh, values, op):
    """`values` (floats) all-reduced over `mesh` with `op`, as floats."""
    t = torch.tensor(values, dtype=torch.float64,
                     device=distributed.mesh_device(mesh))
    dist.all_reduce(t, op=op, group=mesh.get_group())
    return [float(v) for v in t.cpu()]


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(*, device="cuda", N=100, Tf=5.0, lanes=512,
                     log=print):
    """JAX's four tiers on this rank's shard of the mesh over every rank
    (`make_mesh(device)`), with JAX's gates; returns their metrics, every
    one reduced over the mesh (equal on every rank).  Call
    `distributed.init` first on a multi-rank run; on a lone process the
    mesh is a one-rank group.  The lane engines capture their ticks on an
    NCCL mesh and run eagerly on a gloo one (gloo cannot be captured);
    the per-instance engine, which reduces nothing, captures on a CUDA
    device either way.

    1. the lane engine, `lanes` lanes sharded over the mesh, 3 closed-loop
       ticks: converged share > 0.9 (`fleet_metrics`);
    2. the per-instance engine through `make_sharded_batch_solver` on the
       first 4 n scenarios: converged share > 0.9 and its u0 within 5e-4
       of the lane engine's on the same scenarios;
    3. the escalation tier (2 fixed IPM iterations, up to 12 escalation
       steps, adaptive centering), one tick: converged share > 0.9, and
       the same escalation count on every rank;
    4. a 2 n-vehicle, 30-tick `FleetMissionEngine` mission: converged
       share > 0.9 (SUM), clearance > 0 (MIN) and advance > 0.2 m (MIN).
    """
    mesh = make_mesh(device)
    group = mesh.get_group()
    n, rank = mesh.size(), mesh.get_local_rank()
    dev = distributed.mesh_device(mesh)
    tag = f"dryrun_multichip({n}) rank {rank}"
    MAX, MIN, SUM = dist.ReduceOp.MAX, dist.ReduceOp.MIN, dist.ReduceOp.SUM
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(0)
    spec = builders.usv_guidance_ca1(Tf=Tf, N=N)
    kw = dict(device=dev, dtype=DTYPE, group=group,
              capture=dist.get_backend(group) == "nccl")
    out = {}

    # ---- 1. the lane engine, the lane axis sharded over the mesh ----
    L = max(lanes, 2 * n)
    L -= L % n
    x0b = np.broadcast_to(sc.x0, (L, 8)).astype(np.float32).copy()
    x0b[:, 2] += 0.1 * rng.standard_normal(L)   # de-correlate instances
    pL = np.broadcast_to(np.asarray(sc.params, np.float32)[:, None], (16, L))
    lhL = np.broadcast_to(np.asarray(sc.lh, np.float32)[:, None], (8, L))
    x0L = to_lanes(torch.as_tensor(x0b))
    xL, pL, lhL = shard_lanes(mesh, (x0L, pL, lhL))
    lane = LaneRTISolver(spec, ipm_iters=IPM_ITERS, **kw)
    lstate = lane.init_state(shard_batch(mesh, x0b))
    for _ in range(TICKS):                      # closed-loop warm start
        lstate, louts = lane.step_fn(lstate, xL, pL, lhL)
        xL = louts.x1
    _check(louts.u0.shape == (1, L // n), f"lane u0 {tuple(louts.u0.shape)}")
    _check(bool(torch.isfinite(louts.u0).all()), "lane u0 not finite")
    frac, gmax = (float(v) for v in fleet_metrics(mesh, louts.status,
                                                   louts.gap))
    _check(frac > 0.9, f"lane engine fleet unhealthy: converged frac="
           f"{frac:.2f}")
    out.update(lane_frac=frac, lane_gmax=gmax)
    log(f"{tag}: lane engine ok - flagship shape N={N}, L={L}, converged "
        f"frac={frac:.2f}, max gap={gmax:.2e}")

    # ---- 2. the per-instance engine on a fleet subset, sharded ----
    B = 4 * n
    solver = RTISolver(spec, ipm_iters=IPM_ITERS, device=dev, dtype=DTYPE)
    x0s, params, lhs = shard_batch(mesh, (
        x0b[:B], np.broadcast_to(np.asarray(sc.params, np.float32), (B, 16)),
        np.broadcast_to(np.asarray(sc.lh, np.float32), (B, 8))))
    states = solver.init_state(x0s)
    step = make_sharded_batch_solver(solver, mesh, donate=False)
    for _ in range(TICKS):
        states, outs = step(states, x0s, params, lhs)
        x0s = outs.x1
    _check(outs.u0.shape == (B // n, 1), f"instance u0 {tuple(outs.u0.shape)}")
    frac, gmax = (float(v) for v in fleet_metrics(mesh, outs.status,
                                                   outs.qp_gap))
    _check(np.isfinite(gmax), "per-instance max gap not finite")
    _check(frac > 0.9, f"per-instance fleet unhealthy: converged frac="
           f"{frac:.2f}")
    # the lane engine's u0 on this rank's scenarios: every rank's lanes
    # gathered (the instance rows r*B/n.. sit on any rank's lanes)
    lane_u0 = [torch.empty_like(louts.u0[0]) for _ in range(n)]
    dist.all_gather(lane_u0, louts.u0[0].contiguous(), group=group)
    b = B // n
    mine = torch.cat(lane_u0)[rank * b:(rank + 1) * b]
    dev_u0 = _reduce(mesh, [float((mine - outs.u0[:, 0]).abs().max())],
                     MAX)[0]
    _check(dev_u0 < 5e-4, f"cross-engine u0 deviation {dev_u0:.2e}")
    out.update(instance_frac=frac, instance_gmax=gmax, cross_engine_u0=dev_u0)
    log(f"{tag}: ok - per-instance fleet frac={frac:.2f}, max gap="
        f"{gmax:.2e}, cross-engine u0 dev={dev_u0:.2e}")

    # ---- 3. the escalation tier: adaptive centering, a starved fixed
    # budget so that the escalation steps run, their predicate reduced
    # over the mesh ----
    esc = LaneRTISolver(spec, ipm_iters=2, extra_iters=12, ipm_tol=3e-6,
                        centering="adaptive", **kw)
    estate = esc.init_state(shard_batch(mesh, x0b))
    xE = shard_lanes(mesh, x0L)
    estate, eouts = esc.step_fn(estate, xE, pL, lhL)
    _check(bool(torch.isfinite(eouts.u0).all()), "escalation u0 not finite")
    frac, gmax = (float(v) for v in fleet_metrics(mesh, eouts.status,
                                                   eouts.gap))
    steps = int(esc.last_esc_iters)
    lo, hi = _reduce(mesh, [-steps, steps], MAX)
    _check(-lo == hi, f"escalation steps differ across ranks: {-lo}..{hi}")
    _check(frac > 0.9, f"escalation tier unhealthy under mesh: frac="
           f"{frac:.2f}")
    out.update(escalation_frac=frac, escalation_gmax=gmax,
               escalation_steps=steps)
    log(f"{tag}: escalation tier ok - 2+esc12 schedule, {steps} escalation "
        f"steps, converged frac={frac:.2f}, max gap={gmax:.2e}")

    # ---- 4. a sharded fleet mission: distinct waypoints per vehicle,
    # live top-8 LiDAR intake, metrics reduced over the mesh ----
    Bm = 2 * n
    field, valid = scenarios.challenge0_field()
    offs = np.linspace(-1.2, 1.2, Bm).astype(np.float32)
    wps = np.stack([np.array([[4.0 + o, -5.0], [4.0 + o, 25.0]], np.float32)
                    for o in offs])                       # (Bm, 2, 2)
    meas0 = Measurements(
        u=np.full((Bm,), 0.7, np.float32), v=np.zeros((Bm,), np.float32),
        nedx=(4.0 + offs).astype(np.float32),
        nedy=np.full((Bm,), -4.0, np.float32),
        psi=np.full((Bm,), np.pi / 2, np.float32))
    meas_s, wps_s, nwp_s = shard_batch(mesh, (meas0, wps,
                                              np.full((Bm,), 2)))
    fleet = FleetMissionEngine(spec, ipm_iters=IPM_ITERS, **kw)
    mlog = fleet.run(meas_s, wps_s, nwp_s, field, valid,
                     n_steps=MISSION_TICKS)
    _check(bool(torch.isfinite(mlog.pos).all()), "mission track not finite")
    rows = torch.as_tensor(field[valid], dtype=DTYPE, device=dev)
    d = (torch.linalg.vector_norm(mlog.pos[:, :, None, :]
                                  - rows[None, None, :, :2], dim=-1)
         - rows[None, None, :, 2])
    n_ok, n_all = _reduce(mesh, [float((mlog.status == 0).sum()),
                                 float(mlog.status.numel())], SUM)
    clear, adv = _reduce(mesh, [float(d.min()),
                                float(mlog.final.meas.nedy.min()) + 4.0], MIN)
    mfrac = n_ok / n_all
    _check(mfrac > 0.9, f"mission fleet converged frac {mfrac:.2f}")
    # vehicles start 1 m before the field and never touch a buoy
    _check(clear > 0.0, f"mission fleet clearance {clear:.2f} m")
    _check(adv > 0.2, f"fleet did not advance ({adv:.2f} m)")
    out.update(mission_frac=mfrac, mission_clearance=clear,
               mission_advance=adv)
    log(f"{tag}: mission tier ok - {Bm} vehicles x {MISSION_TICKS} ticks, "
        f"converged frac={mfrac:.2f}, min clearance={clear:.2f} m, min "
        f"advance={adv:.2f} m")
    return out


# ---- the launcher ----

def launch(ranks: int, argv, timeout: float):
    """Run `python *argv` as `ranks` ranks of one process group on this
    host through torchrun (`torch.distributed.run --standalone`, which
    sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT for
    each rank, one CPU thread each unless OMP_NUM_THREADS says otherwise,
    and stops them all once one fails).  Returns (exit code, the ranks'
    output); after `timeout` seconds torchrun is stopped, and stops the
    ranks (exit code None)."""
    # the package importable from wherever the ranks start
    root = str(pathlib.Path(__file__).resolve().parents[2])
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={ranks}", "--no-python", sys.executable, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": path})
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.terminate()                # torchrun stops its ranks on SIGTERM
        return None, proc.communicate()[0]
    return proc.returncode, out


RESULT = "dryrun result: "
MODULE = "mpc_collisionavoidance_tpu_torch.parallel.dryrun"


def _line(text):
    """`text` and its newline in one write, so that the ranks' lines,
    which share torchrun's output, do not interleave."""
    sys.stdout.write(text + "\n")
    sys.stdout.flush()


def _worker(args):
    """One rank of the launcher's run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.init(device=args.device,
                     timeout=datetime.timedelta(seconds=args.timeout))
    try:
        out = dryrun_multichip(device=args.device, N=args.N, Tf=args.tf,
                               lanes=args.lanes, log=_line)
        _line(RESULT + json.dumps(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpc_collisionavoidance_tpu_torch.parallel.dryrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for the whole run and for each rank's "
                    "process group")
    ap.add_argument("--N", type=int, default=100)
    ap.add_argument("--tf", type=float, default=5.0)
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args)
        return 0
    # rank r runs cuda:r under NCCL, or the CPU under gloo
    device = distributed.rank_device(args.device)
    distributed.check_backend(distributed.default_backend(device), device,
                              args.ranks)
    code, out = launch(args.ranks, ["-m", MODULE, "--worker", *argv],
                       args.timeout)
    print(out.rstrip())
    metrics = [json.JSONDecoder().raw_decode(ln.split(RESULT, 1)[1])[0]
               for ln in out.splitlines() if RESULT in ln]
    if code != 0 or len(metrics) != args.ranks:
        print(f"dryrun: the ranks failed (exit {code}, {len(metrics)} of "
              f"{args.ranks} results)", file=sys.stderr)
        return 1
    if any(m != metrics[0] for m in metrics):
        print("dryrun: the ranks' reduced metrics differ", file=sys.stderr)
        return 1
    print(f"dryrun: {args.ranks} rank(s) ok: {json.dumps(metrics[0])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
