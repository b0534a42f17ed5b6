"""One rank of `tests/test_torch_parallel.py`'s two-rank gloo run of the
port's `parallel/` layer on the CPU, and the inputs that the test feeds
the JAX package too.  Imports no JAX.

    python tests/torch_parallel_worker.py OUTDIR

under `parallel.dryrun.launch` (torchrun, which sets RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT) writes OUTDIR/rank<r>.npz.
"""

import datetime
import sys

import numpy as np

N, TF = 8, 0.4              # the flagship at the test size
B_GLOBAL = 16               # the sharded per-instance batch
L_ESC = 16                  # the escalation tier's lanes
FLEET = 4                   # the mission tier's vehicles
MISSION_TICKS = 5
TIMEOUT_S = 120             # each rank's process-group timeout


def metric_inputs():
    """Global statuses (16,) int32 and gaps (16,) float64 for
    `fleet_metrics`."""
    rng = np.random.default_rng(3)
    return (rng.choice([0, 0, 0, 1, 2], 16).astype(np.int32),
            10.0 ** rng.uniform(-9, -3, 16))


def batch_inputs():
    """The per-instance tier: x0s (16, 8), params (16, 16), lhs (16, 8)
    (tests/test_multihost.py's scenario, perturbed per instance)."""
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(1)
    x0s = np.broadcast_to(sc.x0, (B_GLOBAL, 8)).astype(np.float64).copy()
    x0s[:, 2] += 0.05 * rng.standard_normal(B_GLOBAL)
    return (x0s, np.broadcast_to(sc.params, (B_GLOBAL, 16)).copy(),
            np.broadcast_to(sc.lh, (B_GLOBAL, 8)).copy())


def escalation_inputs():
    """The escalation tier's global lane inputs x0b (16, 8) batch-first,
    params (16, 16) and lh (8, 16) lane-minor.  The second half of the
    lanes (rank 1's) has obstacles around the boat, so that its QPs take
    more escalation steps than rank 0's: a rank-local predicate would stop
    rank 0 earlier than the mesh-wide one."""
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    sc = scenarios.guidance_ca1_default()
    rng = np.random.default_rng(0)
    x0b = np.broadcast_to(sc.x0, (L_ESC, 8)).astype(np.float64).copy()
    x0b[:, 2] += 0.1 * rng.standard_normal(L_ESC)
    p = np.broadcast_to(np.asarray(sc.params, float)[:, None],
                        (16, L_ESC)).copy()
    lh = np.broadcast_to(np.asarray(sc.lh, float)[:, None],
                         (8, L_ESC)).copy()
    h = L_ESC // 2
    p[:, h:] = rng.uniform(-2, 2, (16, h)) * 0.5
    return x0b, p, lh


ESC_KW = dict(ipm_iters=2, extra_iters=12, ipm_tol=3e-6,
              centering="adaptive")


def mission_inputs():
    """`dryrun_multichip`'s mission tier at FLEET vehicles: (meas0 fields,
    waypoints (B, 2, 2), n_wp (B,), field, valid)."""
    from mpc_collisionavoidance_tpu_torch.sim import scenarios
    field, valid = scenarios.challenge0_field()
    offs = np.linspace(-1.2, 1.2, FLEET)
    wps = np.stack([np.array([[4.0 + o, -5.0], [4.0 + o, 25.0]])
                    for o in offs])
    meas0 = (np.full(FLEET, 0.7), np.zeros(FLEET), 4.0 + offs,
             np.full(FLEET, -4.0), np.full(FLEET, np.pi / 2))
    return meas0, wps, np.full(FLEET, 2), field, valid


def main(outdir):
    import torch
    import torch.distributed as dist

    from mpc_collisionavoidance_tpu_torch.guidance.controller import (
        Measurements)
    from mpc_collisionavoidance_tpu_torch.ocp import builders
    from mpc_collisionavoidance_tpu_torch.parallel import (
        distributed, fleet_metrics, make_mesh, make_sharded_batch_solver,
        shard_batch)
    from mpc_collisionavoidance_tpu_torch.parallel.dryrun import (
        dryrun_multichip)
    from mpc_collisionavoidance_tpu_torch.parallel.sharding import (
        shard_lanes)
    from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetMissionEngine
    from mpc_collisionavoidance_tpu_torch.solver.batch import (LaneRTISolver,
                                                               to_lanes)
    from mpc_collisionavoidance_tpu_torch.solver.sqp_rti import RTISolver

    torch.set_num_threads(1)
    F64 = torch.float64
    rank = distributed.init(device="cpu",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    mesh = make_mesh(device="cpu")
    assert mesh.size() == 2
    spec = builders.usv_guidance_ca1(Tf=TF, N=N)
    out = {}

    # fleet_metrics
    st, gp = shard_batch(mesh, metric_inputs())
    frac, gmax = fleet_metrics(mesh, st, gp)
    out.update(metrics=np.array([float(frac), float(gmax)]))

    try:
        shard_batch(mesh, np.zeros((7, 3)))
    except ValueError:
        out["uneven_refused"] = np.array(True)

    # the sharded per-instance step, on global DTensors as JAX's test
    solver = RTISolver(spec, ipm_iters=4, device="cpu", dtype=F64)
    x0s, params, lhs = shard_batch(mesh, batch_inputs())
    states = solver.init_state(x0s)
    states, x0g, pg, lhg = distributed.shard_batch_global(
        mesh, (states, x0s, params, lhs))
    out.update(global_shape=np.array(x0g.shape))
    step = make_sharded_batch_solver(solver, mesh, donate=False)
    states, outs = step(states, x0g, pg, lhg)
    frac, gmax = fleet_metrics(mesh, outs.status, outs.qp_gap)
    out.update(batch_metrics=np.array([float(frac), float(gmax)]),
               batch_global_u0_shape=np.array(outs.u0.shape))
    outs = outs._replace(**{k: v.to_local() for k, v in
                            outs._asdict().items()})
    out.update({f"batch_{k}": v.numpy() for k, v in outs._asdict().items()})

    # the escalation tier, the lane axis sharded; and the same lanes with
    # a rank-local predicate (no mesh)
    x0b, p, lh = escalation_inputs()
    for label, group in (("esc", mesh.get_group()), ("local", None)):
        esc = LaneRTISolver(spec, **ESC_KW, device="cpu", dtype=F64,
                            group=group)
        state = esc.init_state(shard_batch(mesh, x0b))
        xs, ps, lhs_ = shard_lanes(mesh, (to_lanes(torch.as_tensor(x0b)),
                                          p, lh))
        state, o = esc.step_fn(state, xs, ps, lhs_)
        out.update({f"{label}_{k}": v.numpy() for k, v in
                    (*o._asdict().items(), *state._asdict().items())})
        out[f"{label}_steps"] = np.array(int(esc.last_esc_iters))

    # the mission tier, the vehicle axis sharded; its metrics reduced
    meas0, wps, n_wp, field, valid = mission_inputs()
    meas_s, wps_s, nwp_s = shard_batch(mesh, (Measurements(*meas0), wps,
                                              n_wp))
    fleet = FleetMissionEngine(spec, ipm_iters=10, device="cpu", dtype=F64,
                               group=mesh.get_group())
    mlog = fleet.run(meas_s, wps_s, nwp_s, field, valid,
                     n_steps=MISSION_TICKS)
    out.update({f"mission_{k}": getattr(mlog, k).numpy() for k in
                 ("pos", "ye", "psi_d", "active", "collision", "status")})
    rows = torch.as_tensor(field[valid])
    d = (torch.linalg.vector_norm(mlog.pos[:, :, None, :]
                                  - rows[None, None, :, :2], dim=-1)
         - rows[None, None, :, 2])
    counts = torch.tensor([float((mlog.status == 0).sum()),
                           float(mlog.status.numel())], dtype=F64)
    mins = torch.stack([d.min(), mlog.final.meas.nedy.min() + 4.0])
    dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    dist.all_reduce(mins, op=dist.ReduceOp.MIN)
    out.update(mission_metrics=np.array([float(counts[0] / counts[1]),
                                         float(mins[0]), float(mins[1])]))

    # the dryrun's four tiers at the test size, with their gates
    dry = dryrun_multichip(device="cpu", N=N, Tf=TF, lanes=16,
                           log=lambda s: None)
    out.update(dryrun=np.array([dry[k] for k in sorted(dry)]))

    np.savez(f"{outdir}/rank{rank}.npz", **out)
    dist.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
