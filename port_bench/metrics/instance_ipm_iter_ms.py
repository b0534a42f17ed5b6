"""Device ms per IPM iteration of the per-instance tick: the captured
`RTISolver.step_fn` tick's stamps `ipm.start` (before the first
iteration) and `ipm.end` (after the last; its value is the iterations),
the stretch over its iterations, averaged over the window's ticks."""

from port_bench.metrics._trace import MS, point, ticks, trace_of


def read(rec):
    trace = trace_of(rec)
    if trace is None:
        return None
    per_iter = []
    for t in ticks(trace, "instance.step"):
        a, b = point(t, "ipm.start"), point(t, "ipm.end")
        if a and b and b[0]:
            per_iter.append((b[1] - a[1]) / b[0])
    return MS * sum(per_iter) / len(per_iter) if per_iter else None
