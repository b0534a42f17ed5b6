"""Runner `lane_loop`: the lane engine (`solver/batch.py::LaneRTISolver`)
closing B loops at once, each lane's predicted x1 fed back as its next x0
(the solver as the plant), on the traffic's path scenario.

Each lane runs episodes of `episode_ticks` ticks from the starts of its
track (`common.path_starts`); a track's first episode is cut short by an
offset, so lanes meet the obstacles at different times.  The tracks are
drawn from the traffic's `set_seed`, the same for every seed; the seed
orders them over the lanes (`common.lane_order`) and picks the sampled
solves.  Episodes
end at checkpoints every `reset_every` ticks, where the host reads which
lanes reported a non-finite solve since the last one (status 2, a failed
operation) and also waits for the device (the queue stays at most one
checkpoint deep).  A lane ends its episode when it is `episode_ticks`
old or has failed: it restarts from a fresh start with a fresh warm start,
as a node re-initializes its solver after a failure.

End-to-end: `solves_per_s` (lanes x ticks over the window's seconds) and
`converged_frac` (the share of those solves with status 0).  Traced run:
CUDA events around each tick and each `step_fn` replay and the
escalation's iterations per tick over the window, then `trace.ticks`
ticks after it under torch.profiler.
"""

import numpy as np
import torch

from port_bench.runners import common
from port_bench.harness import (EventTimer, Profiled, Result, TickEvents,
                                dtype_of, kernel_summary)


def run(ctx):
    cfg, tr = ctx.config, ctx.traffic
    dev, dtype = ctx.device, dtype_of(cfg)
    spec, engine = common.spec_and_engine(cfg, "lane")
    nx, nu = spec.model.nx, spec.model.nu
    solver = engine.build(spec, device=dev, dtype=dtype,
                          capture=cfg["capture"])
    if ctx.fault is not None:
        solver.step_fn = ctx.fault(solver.step_fn)
    B, ep, every = tr["batch"], tr["episode_ticks"], tr["reset_every"]
    spare = tr["spare_starts"]
    # B tracks, each a first start with its offset and a sequence of
    # restarts from the spares, the same for every seed; the seed orders
    # them over the lanes
    fixed = common.rng_of(tr["set_seed"], 1)
    pool = common.path_starts(fixed, B + spare, tr["starts"])
    track = common.lane_order(ctx.seed, B)
    offsets = fixed.integers(0, ep, B)[track]
    restarts = np.zeros(B, np.int64)
    rng = common.rng_of(ctx.seed, 1)
    sampled = common.sample_ticks(rng, tr, ctx.seconds)
    check_lanes = [rng.choice(B, tr["check"]["lanes"], replace=False)
                   for _ in range(tr["check"]["ticks"])]
    p, lh, yref = common.path_problem(tr["starts"], nx, nu)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    P = t(p)[:, None].expand(len(p), B).contiguous()
    LH, YREF, YREF_E = t(lh), t(yref), t(yref[:nx])
    x0 = t(pool[track].T).contiguous()                     # (nx, B)
    state = solver.init_state(pool[track])
    age = offsets.copy()

    def reset(state, due):
        lanes = np.nonzero(due)[0]
        if lanes.size == 0:
            return
        idx = common.next_of_track(track[lanes], restarts[lanes], B, spare)
        restarts[lanes] += 1
        li = torch.as_tensor(lanes, device=dev)
        new = t(pool[idx].T)                               # (nx, n)
        x0[:, li] = new
        state.xbar[:, :, li] = new[:, None, :]
        state.ubar[:, :, li] = 0.0
        age[lanes] = 0

    conv = torch.zeros(B, dtype=torch.int32, device=dev)
    dead = torch.zeros(B, dtype=torch.int32, device=dev)
    esc = torch.zeros((), dtype=torch.int32, device=dev)
    solves = common.Solves()
    mismatch = 0

    def step(state, rec=None):
        if rec is not None:
            li = torch.as_tensor(rec, device=dev)
            prior = dict(xbar=state.xbar[:, :, li].permute(2, 1, 0).clone(),
                         ubar=state.ubar[:, :, li].permute(2, 1, 0).clone(),
                         x0=x0[:, li].T.clone())
        state, out = solver.step_fn(state, x0, P, LH, yref=YREF,
                                    yref_e=YREF_E)
        if rec is not None:
            nonlocal mismatch
            K = len(rec)
            prior.update(p=P[:, li].T, lh=LH.expand(K, -1),
                         yref=YREF.expand(K, -1), yref_e=YREF_E.expand(K, -1))
            ans = dict(xbar=state.xbar[:, :, li].permute(2, 1, 0),
                       ubar=state.ubar[:, :, li].permute(2, 1, 0))
            solves.add(prior, ans, out.status[li])
            mismatch += common.out_mismatch(out, state, li)
        x0.copy_(out.x1)
        return state, out

    # ---- set-up: capture the tick and the reset's shapes ----
    for _ in range(tr["warm_ticks"]):
        state, out = step(state)
    reset(state, np.zeros(B, bool))
    ctx.sync()

    # traced run: CUDA events around each tick and each step_fn replay;
    # after the window, `trace.ticks` more ticks under the profiler
    ticks_ev = TickEvents(ctx.trace)
    replay = EventTimer()
    ticks = 0
    failed_seen = np.zeros(B, np.int32)
    ctx.open_window()
    while True:
        if ticks and ticks % every == 0:
            failed_now = dead.cpu().numpy()
            if ctx.over(ticks):
                break
            reset(state, (age >= ep) | (failed_now > failed_seen))
            failed_seen = failed_now
        rec = check_lanes[len(solves.prior)] if ticks in sampled else None
        if ctx.trace:
            ticks_ev.begin()
            with replay:
                state, out = step(state, rec)
            esc += solver.last_esc_iters
            ticks_ev.end()
        else:
            state, out = step(state, rec)
        conv += out.status == 0
        dead += out.status == 2
        age += 1
        ticks += 1
    ctx.close_window()
    with Profiled(ctx.trace) as prof:
        for _ in range(tr["trace"]["ticks"] if ctx.trace else 0):
            state, out = step(state)

    n = ticks * B
    e2e = dict(solves_per_s=n / ctx.window_s,
               converged_frac=float(conv.sum()) / n)
    failed = int(dead.sum())
    layer = {}
    if ctx.trace:
        timed = len(replay.pairs)
        layer = dict(lane_tick_ms=replay.ms(),
                     esc_iters=int(esc), esc_ticks=timed,
                     device_busy_window_ms=ticks_ev.busy_window_ms(),
                     kernels=prof.kernels,
                     k1_shape=(spec.N, nx, nu, B),
                     profile_summary=kernel_summary(prof.kernels))
    del solver, state, out
    common.free_device()
    r = common.judge(cfg["ocp"], solves, ctx.device)
    checks = [ctx.check("feas", r["feas"]),
              ctx.check("cost_gap", r["cost_gap"]),
              ctx.check("nonfinite_ok", r["nonfinite_ok"]),
              ctx.check("frozen", r["frozen"]),
              ctx.check("out_mismatch", mismatch)]
    layer["judged"] = r["judged"]
    ctx.solves = solves
    return Result(e2e=e2e, attempted=n, failed=failed, checks=checks,
                  layer=layer)

