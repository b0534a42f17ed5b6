"""Runner `fleet_mission`: the fleet mission engine
(`sim/fleet.py::FleetMissionEngine`, the flagship's guidance stack around
the lane engine) at B vehicles, ticking back to back.

Missions come from `vendor/missions.py`, drawn from the traffic's
`set_seed` (the same for every seed) as B tracks: a first mission that
starts at the start of a drawn leg, with 1-3 legs left, and next missions
from a pool.  The seed orders the tracks over the vehicles
(`common.lane_order`) and picks the sampled solves.  When a mission ends
(done, `max_mission_ticks` old, or after a non-finite solve, status 2)
the vehicle takes its track's next mission.  Ends are read at checkpoints every `reset_every`
ticks, where the host also waits for the device, so the queue stays at
most one checkpoint deep.

End-to-end: `solves_per_s` (vehicles x ticks over the window's seconds)
and `converged_frac` (their status-0 share).  Traced run: the window's
first `trace.event_ticks` ticks with CUDA events around each tick and
each solver call and the escalation's count, the rest with a synced host
span around each tick and around its solver call; then `trace.ticks`
ticks after the window under torch.profiler.
"""

import time

import numpy as np
import torch

from port_bench.runners import common
from port_bench.harness import (EventTimer, Profiled, Result, TickEvents,
                                dtype_of, kernel_summary)
from port_bench.reference import guidance as ref_guidance
from port_bench.vendor.missions import random_missions


def run(ctx):
    from mpc_collisionavoidance_tpu_torch.guidance.controller import (
        Measurements)
    from mpc_collisionavoidance_tpu_torch.sim.fleet import FleetMissionEngine

    cfg, tr = ctx.config, ctx.traffic
    dev, dtype = ctx.device, dtype_of(cfg)
    spec, lane_engine = common.spec_and_engine(cfg, "lane")
    engine = FleetMissionEngine(spec, lane_engine, device=dev,
                                dtype=dtype, capture=cfg["capture"])
    solver = engine.solver
    B, every, max_age = tr["batch"], tr["reset_every"], \
        tr["max_mission_ticks"]
    spare = tr["pool_missions"]
    # B tracks, each a first mission and a sequence of next ones from the
    # pool, the same for every seed; the seed orders them over the boats
    fixed = common.rng_of(tr["set_seed"], 2)
    m = tr["missions"]
    wps, fields, valid, psi0 = random_missions(
        B + spare, fixed, n_wp=m["waypoints"],
        leg=tuple(m["leg_m"]), turn=np.deg2rad(m["turn_deg"]),
        buoys=tuple(m["buoys"]))
    n_wp_all = np.full(len(wps), m["waypoints"], np.int32)
    # the first missions start on a drawn leg: the waypoints from that
    # leg's start on, the boat at its start heading along it
    leg = fixed.integers(0, m["waypoints"] - 1, B)
    for b in range(B):
        rest = wps[b, leg[b]:]
        wps[b] = np.concatenate([rest, np.repeat(rest[-1:], leg[b], 0)])
        d = wps[b, 1] - wps[b, 0]
        psi0[b] = np.arctan2(d[1], d[0])
        n_wp_all[b] = m["waypoints"] - leg[b]
    track = common.lane_order(ctx.seed, B)
    restarts = np.zeros(B, np.int64)
    rng = common.rng_of(ctx.seed, 2)
    sampled = common.sample_ticks(rng, tr, ctx.seconds)
    check_veh = [rng.choice(B, tr["check"]["lanes"], replace=False)
                 for _ in range(tr["check"]["ticks"])]

    def t(a, dt=None):
        return torch.as_tensor(np.asarray(a), dtype=dt or dtype, device=dev)

    def meas_of(idx):
        return Measurements(u=t(np.full(len(idx), m["speed"])),
                            v=t(np.zeros(len(idx))),
                            nedx=t(wps[idx, 0, 0]), nedy=t(wps[idx, 0, 1]),
                            psi=t(psi0[idx]))

    W = t(wps[track])
    NW = t(n_wp_all[track], torch.int32)
    F = t(fields[track])
    V = t(valid[track], torch.bool)
    state = engine.init_state(meas_of(track), W, NW)
    age = np.zeros(B, np.int64)

    def reset(state, vehicles, idx=None):
        """Each of `vehicles` to its track's next mission (or to `idx`)."""
        if vehicles.size == 0:
            return
        if idx is None:
            idx = common.next_of_track(track[vehicles], restarts[vehicles],
                                       B, spare)
            restarts[vehicles] += 1
        vi = torch.as_tensor(vehicles, device=dev)
        W[vi], NW[vi] = t(wps[idx]), t(n_wp_all[idx], torch.int32)
        F[vi], V[vi] = t(fields[idx]), t(valid[idx], torch.bool)
        sub = engine.init_state(meas_of(idx), W[vi], NW[vi])
        for name in ("mission_k", "past_psied", "active"):
            getattr(state, name)[vi] = getattr(sub, name)
        for dst, src in zip(state.meas, sub.meas):
            dst[vi] = src
        state.solver.xbar[:, :, vi] = sub.solver.xbar
        state.solver.ubar[:, :, vi] = sub.solver.ubar
        age[vehicles] = 0

    # ---- the solver's call, wrapped: spans, events and the sampled
    # solves' inputs ----
    call = dict(args=None, span=False, events=False)
    spans, replay = [], EventTimer()
    esc = torch.zeros((), dtype=torch.int32, device=dev)
    inner = solver.step_fn
    if ctx.fault is not None:
        inner = ctx.fault(inner)

    def step_fn(st, x0, p, lh):
        nonlocal esc
        if call["args"] is not None:
            li = call["args"]
            call["prior"] = dict(
                xbar=st.xbar[:, :, li].permute(2, 1, 0).clone(),
                ubar=st.ubar[:, :, li].permute(2, 1, 0).clone(),
                x0=x0[:, li].T.clone(), p=p[:, li].T.clone(),
                lh=lh[:, li].T.clone())
        if call["span"]:
            ctx.sync()
            s0 = time.perf_counter()
        if call["events"]:
            with replay:
                out = inner(st, x0, p, lh)
            esc += solver.last_esc_iters
        else:
            out = inner(st, x0, p, lh)
        if call["span"]:
            ctx.sync()
            spans.append((time.perf_counter() - s0) * 1e3)
        return out

    solver.step_fn = step_fn

    conv = torch.zeros(B, dtype=torch.int32, device=dev)
    dead = torch.zeros(B, dtype=torch.int32, device=dev)
    solves, guid = common.Solves(), []

    def tick(state, rec=None):
        if rec is not None:
            vi = torch.as_tensor(rec, device=dev)
            call["args"] = vi
            g = {k: v[vi] for k, v in zip(
                ("u", "v", "nedx", "nedy", "psi"), state.meas)}
            g.update(k=state.mission_k[vi], past_psied=state.past_psied[vi],
                     active=state.active[vi], n_wp=NW[vi],
                     waypoints=W[vi], field=F[vi], valid=V[vi])
            g = {k: v.clone() for k, v in g.items()}
        new, log = engine.tick(state, W, NW, F, V)
        if rec is not None:
            call["args"] = None
            pr = call.pop("prior")
            K = len(rec)
            zeros = torch.zeros((K, spec.cost.ny), dtype=dtype, device=dev)
            prior = dict(pr, yref=zeros, yref_e=zeros[:, :spec.model.nx])
            ans = dict(xbar=new.solver.xbar[:, :, vi].permute(2, 1, 0),
                       ubar=new.solver.ubar[:, :, vi].permute(2, 1, 0))
            solves.add(prior, ans, log[5][vi])
            prog = dict(x0=pr["x0"], p_obs=pr["p"], r_obs=pr["lh"],
                        k=new.mission_k[vi], active=new.active[vi],
                        past_psied=new.past_psied[vi],
                        u0=ans["ubar"][:, 0, 0], x1=ans["xbar"][:, 1])
            prog.update({k: v[vi] for k, v in zip(
                ("u", "v", "nedx", "nedy", "psi"), new.meas)})
            guid.append(({k: v.to("cpu", torch.float64)
                          for k, v in g.items()},
                         {k: v.to("cpu", torch.float64)
                          for k, v in prog.items()}))
        return new, log

    # ---- set-up: run the reset once (every boat to the start of its
    # first mission, where it is), then capture the tick ----
    reset(state, np.arange(B), track)
    for _ in range(tr["warm_ticks"]):
        state, log = tick(state)
    ctx.sync()

    # traced run: CUDA events for the window's first `trace.event_ticks`
    # ticks, synced host spans for the rest; after the window,
    # `trace.ticks` more ticks under the profiler
    n_ev = tr["trace"]["event_ticks"] if ctx.trace else 0
    ticks_ev = TickEvents(ctx.trace)
    tick_spans = []
    ticks = 0
    failed_seen = np.zeros(B, np.int32)
    ctx.open_window()
    while True:
        if ticks and ticks % every == 0:
            active = state.active.cpu().numpy()
            failed_now = dead.cpu().numpy()
            if ctx.over(ticks):
                break
            age += every
            reset(state, np.nonzero(~active | (age >= max_age)
                                    | (failed_now > failed_seen))[0])
            failed_seen = failed_now
        rec = check_veh[len(solves.prior)] if ticks in sampled else None
        call["events"] = ctx.trace and ticks < n_ev
        call["span"] = ctx.trace and ticks >= n_ev
        if call["events"]:
            ticks_ev.begin()
        if call["span"]:
            ctx.sync()
            t0 = time.perf_counter()
        state, log = tick(state, rec)
        if call["span"]:
            ctx.sync()
            tick_spans.append((time.perf_counter() - t0) * 1e3)
        if call["events"]:
            ticks_ev.end()
        conv += log[5] == 0
        dead += log[5] == 2
        ticks += 1
    ctx.close_window()
    call["events"] = call["span"] = False
    with Profiled(ctx.trace) as prof:
        for _ in range(tr["trace"]["ticks"] if ctx.trace else 0):
            state, log = tick(state)

    n = ticks * B
    e2e = dict(solves_per_s=n / ctx.window_s,
               converged_frac=float(conv.sum()) / n)
    failed = int(dead.sum())
    layer = {}
    if ctx.trace:
        layer = dict(fleet_tick_ms=tick_spans, solver_call_ms=spans,
                     lane_tick_ms=replay.ms(), esc_iters=int(esc),
                     esc_ticks=len(replay.pairs),
                     device_busy_window_ms=ticks_ev.busy_window_ms(),
                     kernels=prof.kernels,
                     k1_shape=(spec.N, spec.model.nx, spec.model.nu, B),
                     profile_summary=kernel_summary(prof.kernels))
    del engine, solver, state, log
    common.free_device()
    r = common.judge(cfg["ocp"], solves, ctx.device)
    gr = [ref_guidance.readings(g, p) for g, p in guid]
    worst = {k: max([x[k] for x in gr], default=float("inf"))
             for k in ("guidance", "plant", "mission")}
    checks = [ctx.check("feas", r["feas"]),
              ctx.check("cost_gap", r["cost_gap"]),
              ctx.check("nonfinite_ok", r["nonfinite_ok"]),
              ctx.check("frozen", r["frozen"]),
              ctx.check("guidance", worst["guidance"]),
              ctx.check("plant", worst["plant"]),
              ctx.check("mission", worst["mission"])]
    layer["judged"] = r["judged"]
    ctx.solves, ctx.guidance = solves, guid
    return Result(e2e=e2e, attempted=n, failed=failed, checks=checks,
                  layer=layer)
