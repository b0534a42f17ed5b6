"""Device ms per fleet tick of the guidance stack's work: the intervals
between the CUDA events at the ends of the spans `guidance_host_ms`
reads, summed per tick and averaged over the window's ticks that do not
start on a drained device (`_trace.drained`).  In those the host runs
ahead, so each span's work runs back to back on the device; in a drained
tick the device waits for the host's launches inside the spans, and
their intervals hold the host's pace."""

from port_bench.metrics._trace import MS, by_id, drained, trace_of
from port_bench.metrics.guidance_host_ms import GUIDANCE


def read(rec):
    trace = trace_of(rec)
    if trace is None:
        return None
    idle = drained(trace, "fleet.tick")
    per_tick = [sum(s["device"][1] - s["device"][0] for s in spans)
                for tid, spans in by_id(trace, GUIDANCE).items()
                if tid not in idle and all(s["device"] for s in spans)]
    return MS * sum(per_tick) / len(per_tick) if per_tick else None
