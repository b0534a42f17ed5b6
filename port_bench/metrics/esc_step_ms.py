"""Device ms per escalation step that ran: the stamps at each step's
body's start and end (inside its IF node) in the captured
`LaneRTISolver.step_fn` ticks, summed over the window and divided by the
steps' count."""

from port_bench.metrics._trace import MS, esc_steps, ticks, trace_of


def read(rec):
    trace = trace_of(rec)
    if trace is None:
        return None
    steps = [b - a for t in ticks(trace, "lane.step") for a, b in esc_steps(t)]
    return MS * sum(steps) / len(steps) if steps else None
