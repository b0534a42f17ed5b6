"""Device ms per lane tick outside its escalation steps: the captured
`LaneRTISolver.step_fn` tick's stamps, from `tick.start` to `tick.end`
less each escalation step's (`esc.start` to `esc.end`, inside its IF
node), averaged over the window's ticks."""

from port_bench.metrics._trace import MS, esc_steps, ticks, trace_of


def read(rec):
    trace = trace_of(rec)
    if trace is None:
        return None
    fixed = [t["end"] - t["start"] - sum(b - a for a, b in esc_steps(t))
             for t in ticks(trace, "lane.step")]
    return MS * sum(fixed) / len(fixed) if fixed else None
