"""Readings of the program's own trace (`program_trace`: what
`mpc_collisionavoidance_tpu_torch.utils.profiling.records()` returns over
the window; host ns on one clock): the spans of one tick by their shared
id, and the captured ticks' device stamps."""

import bisect

MS = 1e-6       # ms per ns
K1 = "riccati_lanes_kernel"


def trace_of(rec):
    """The record's program trace, or None where it has none (tracing was
    off, or a program without the tracer)."""
    trace = rec.get("program_trace")
    return trace or None


def by_id(trace, names):
    """{id: [spans]} of the spans named in `names`."""
    out = {}
    for s in trace.get("spans", ()):
        if s["name"] in names:
            out.setdefault(s["id"], []).append(s)
    return out


def ticks(trace, program):
    """The device ticks of the programs named `program` (e.g.
    "lane.step"): one dict per tick, from its `tick.start` stamp to its
    `tick.end`, with `points` the (point, value, ns) stamped between."""
    ids = {p["id"] for p in trace.get("programs", ()) if p["name"] == program}
    out, cur = [], {}
    for t, pid, point, value in trace.get("stamps", ()):
        if pid not in ids:
            continue
        if point == "tick.start":
            cur[pid] = dict(start=t, points=[])
        elif pid in cur:
            if point == "tick.end":
                tick = cur.pop(pid)
                tick["end"] = t
                out.append(tick)
            else:
                cur[pid]["points"].append((point, value, t))
    return out


def drained(trace, name):
    """The ids of the spans named `name` (one a tick) that start on a
    drained device: at the span's host start, the device has run the work
    of every span that ended on the host before it (a sync between ticks,
    as at the runner's checkpoints).  In such a tick the host's launches
    do not wait for the launch queue, which is full once the host runs a
    tick or two ahead.  On a host-only trace, every such span."""
    spans = trace.get("spans", ())
    ends = sorted((s["host"][1], s["device"][1]) for s in spans
                  if s.get("device"))
    out, i, done = set(), 0, None
    for s in sorted((s for s in spans if s["name"] == name),
                    key=lambda s: s["host"][0]):
        while i < len(ends) and ends[i][0] <= s["host"][0]:
            done = ends[i][1] if done is None else max(done, ends[i][1])
            i += 1
        if done is None or done <= s["host"][0]:
            out.add(s["id"])
    return out


def esc_steps(tick):
    """(start ns, end ns) of each escalation step that ran in `tick`."""
    starts = {v: t for p, v, t in tick["points"] if p == "esc.start"}
    return [(starts[v], t) for p, v, t in tick["points"]
            if p == "esc.end" and v in starts]


def point(tick, name):
    """(value, ns) of the first stamp at `name` in `tick`, or None."""
    for p, v, t in tick["points"]:
        if p == name:
            return v, t
    return None


def innermost(spans, t):
    """The name of the innermost span open at host ns `t` (the latest to
    start of those open), or "(no span)": the host is outside the
    program (in its caller)."""
    best = None
    for s in spans:
        a, b = s["host"]
        if a <= t < b and (best is None or a >= best["host"][0]):
            best = s
    return best["name"] if best else "(no span)"


def host_gaps(trace, n=10):
    """The `n` longest stretches in which no innermost span's device
    interval is open (the device has no work queued from a span: a
    parent's interval runs from its first work to its last and would
    cover its children's gaps), each named by the innermost span open on
    the host at its start: [[name, seconds]]."""
    spans = trace.get("spans", ())
    parents = {s["parent"] for s in spans}
    ivs = sorted(tuple(s["device"]) for s in spans
                 if s.get("device") and s["seq"] not in parents)
    if not ivs:
        return None
    gaps, end = [], ivs[0][1]
    for a, b in ivs[1:]:
        if a > end:
            gaps.append((a - end, end))
        end = max(end, b)
    gaps.sort(reverse=True)
    return [[innermost(spans, t), g * 1e-9] for g, t in gaps[:n]]


def clock_violations(trace, program="lane.step", slack_ns=50_000):
    """(ticks checked, ticks whose stamps do not all lie within `slack_ns`
    of the device interval of a `<layer>.launch` span's events, the worst
    distance in ns): the stamps' clock held to the events'."""
    layer = program.split(".")[0]
    launches = sorted(tuple(s["device"]) for s in trace.get("spans", ())
                      if s["name"] == f"{layer}.launch" and s.get("device"))
    starts = [a for a, _ in launches]
    checked = bad = worst = 0
    for tick in ticks(trace, program):
        checked += 1
        i = bisect.bisect_right(starts, tick["start"] + slack_ns) - 1
        if i < 0:
            bad += 1
            continue
        a, b = launches[i]
        ts = [tick["start"], tick["end"]] + [t for _, _, t in tick["points"]]
        d = max(max(a - t, t - b, 0) for t in ts)
        worst = max(worst, d)
        bad += d > slack_ns
    return checked, bad, worst


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def instance_split(trace):
    """ms per per-instance tick from its stamps: `qp` (start to the QP
    built), `ipm_setup` (to the IPM's first iteration), `ipm` (its
    iterations), `finish` (the status, the step and the state's writes,
    to the tick's end) and `tick` (start to end)."""
    parts = {k: [] for k in ("qp", "ipm_setup", "ipm", "finish", "tick")}
    for t in ticks(trace, "instance.step"):
        qp, a, b = (point(t, n) for n in ("qp.built", "ipm.start",
                                          "ipm.end"))
        if not (qp and a and b):
            continue
        for k, x, y in (("qp", t["start"], qp[1]), ("ipm_setup", qp[1], a[1]),
                        ("ipm", a[1], b[1]), ("finish", b[1], t["end"]),
                        ("tick", t["start"], t["end"])):
            parts[k].append((y - x) * MS)
    return {k: _mean(v) for k, v in parts.items()}


def profiled_vs_stamps(kernels, trace, program):
    """Ticks profiled by torch.profiler (`kernels`: its device events,
    (name, start us, end us)) beside their stamps in `trace`: K1's
    launches and device ms and the device ops inside each span's range
    (the spans' `record_function` ranges come back as device events of
    the span's name), against the stamped ticks and escalation steps."""
    tk = ticks(trace, program)
    if not kernels or not tk:
        return None
    names = {s["name"] for s in trace.get("spans", ())}
    ranges = [k for k in kernels if k[0] in names]
    ops = [k for k in kernels if k[0] not in names]
    k1 = [e - s for name, s, e in ops if K1 in name]
    steps = [b - a for t in tk for a, b in esc_steps(t)]
    per_span = {}
    for name, a, b in ranges:
        n = sum(1 for _, s, _ in ops if a <= s < b)
        c = per_span.setdefault(name, [0, 0])
        c[0], c[1] = c[0] + 1, c[1] + n
    return dict(ticks=len(tk), esc_steps=len(steps),
                esc_ms_stamped=sum(steps) * MS,
                tick_ms_stamped=sum(t["end"] - t["start"] for t in tk) * MS,
                profiled_k1_launches=len(k1),
                profiled_k1_ms=sum(k1) * 1e-3,
                ops_per_range={k: v[1] / v[0] for k, v in per_span.items()})
