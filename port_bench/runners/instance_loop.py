"""Runner `instance_loop`: one boat's node loop on the per-instance engine
(`solver/sqp_rti.py::RTISolver`, captured) at B=1, ticking back to back.

Each tick hands the solver the boat's x0, fetches u0 to the host (what a
node sends its thrusters) and feeds the predicted x1 back as the next x0
(the solver as the plant).  Episodes of `episode_ticks` ticks start from
a set of `starts_set` starts on the path scenario (`common.path_starts`,
drawn from `starts_set_seed`, the same for every seed) in the seed's
order, each with a fresh warm start: a window covers the set about
once, so every seed does the same work.  A tick that reports a
non-finite solve (status 2, a failed operation) ends its episode, as a
node re-initializes its solver after a failure.

End-to-end: `tick_p95_ms`, the 95th percentile over every tick of the
window, each from the call into `step_fn` until u0 is on the host, and
`converged_frac`.  Traced run: CUDA events around each tick and each
replay over the window, the step program's graph nodes, and
`trace.ticks` ticks after the window under torch.profiler.
"""

import time

import numpy as np
import torch

from port_bench.runners import common
from port_bench.harness import (EventTimer, Profiled, Result, TickEvents,
                                dtype_of, kernel_summary)


def run(ctx):
    cfg, tr = ctx.config, ctx.traffic
    dev, dtype = ctx.device, dtype_of(cfg)
    spec, engine = common.spec_and_engine(cfg, "instance")
    nx, nu, N = spec.model.nx, spec.model.nu, spec.N
    solver = engine.build(spec, device=dev, dtype=dtype,
                          capture=cfg["capture"])
    step_fn = solver.step_fn if ctx.fault is None else ctx.fault(
        solver.step_fn)
    ep = tr["episode_ticks"]
    # one set of starts for every seed, which the seed puts in its order:
    # a window holds about as many episodes as the set has starts
    starts = common.path_starts(common.rng_of(tr["starts_set_seed"], 3),
                                tr["starts_set"], tr["starts"])
    rng = common.rng_of(ctx.seed, 3)
    starts = starts[rng.permutation(len(starts))]
    sampled = common.sample_ticks(rng, tr, ctx.seconds)
    p, lh, yref = common.path_problem(tr["starts"], nx, nu)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    P, LH, YREF, YREF_E = t(p), t(lh), t(np.tile(yref, (N, 1))), \
        t(yref[:nx])
    episode = 0

    def fresh_episode():
        nonlocal episode
        x0 = t(starts[episode % len(starts)])
        episode += 1
        return solver.init_state(x0), x0

    state, x0 = fresh_episode()
    solves = common.Solves()

    def tick(state, x0, rec=False):
        if rec:
            prior = dict(xbar=state.xbar[None].clone(),
                         ubar=state.ubar[None].clone(), x0=x0[None].clone(),
                         p=P[None], lh=LH[None], yref=YREF[None, 0],
                         yref_e=YREF_E[None])
        state, out = step_fn(state, x0, P, LH, YREF, YREF_E)
        u0 = out.u0.cpu()
        if rec:
            solves.add(prior, dict(xbar=state.xbar[None],
                                   ubar=state.ubar[None]), out.status)
        return state, out, u0

    for _ in range(tr["warm_ticks"]):
        state, out, _ = tick(state, x0)
        x0 = out.x1
    episode = 0
    state, x0 = fresh_episode()
    ctx.sync()

    ticks_ev = TickEvents(ctx.trace)
    replay = EventTimer()
    lat, status = [], []
    ticks = 0
    ctx.open_window()
    since = 0
    failed_last = False
    while not ctx.over(ticks):
        if since == ep or failed_last:
            state, x0 = fresh_episode()
            since = 0
        rec = ticks in sampled
        if ctx.trace:
            ticks_ev.begin()
        t0 = time.perf_counter()
        if ctx.trace:
            with replay:
                state, out, u0 = tick(state, x0, rec)
        else:
            state, out, u0 = tick(state, x0, rec)
        lat.append((time.perf_counter() - t0) * 1e3)
        if ctx.trace:
            ticks_ev.end()
        status.append(out.status)
        failed_last = int(out.status) == 2
        x0 = out.x1
        ticks += 1
        since += 1
    ctx.close_window()
    with Profiled(ctx.trace) as prof:
        for _ in range(tr["trace"]["ticks"] if ctx.trace else 0):
            state, out, _ = tick(state, x0)
            x0 = out.x1

    st = torch.stack(status).cpu()
    conv, dead = int((st == 0).sum()), int((st == 2).sum())
    e2e = dict(tick_p95_ms=float(np.percentile(lat, 95)),
               converged_frac=conv / ticks)
    layer = {}
    if ctx.trace:
        programs = [pr for key, pr in solver._graphs.programs.items()
                    if key[0] == "step"] if solver._graphs else []
        layer = dict(instance_replay_ms=replay.ms(),
                     graph_nodes=programs[0].nodes if programs else None,
                     device_busy_window_ms=ticks_ev.busy_window_ms(),
                     kernels=prof.kernels, k1_shape=(N, nx, nu, 1),
                     profile_summary=kernel_summary(prof.kernels))
    del solver, state, out
    common.free_device()
    r = common.judge(cfg["ocp"], solves, ctx.device)
    checks = [ctx.check("feas", r["feas"]),
              ctx.check("cost_gap", r["cost_gap"]),
              ctx.check("nonfinite_ok", r["nonfinite_ok"]),
              ctx.check("frozen", r["frozen"])]
    layer["judged"] = r["judged"]
    ctx.solves = solves
    return Result(e2e=e2e, attempted=ticks, failed=dead, checks=checks,
                  layer=layer)
