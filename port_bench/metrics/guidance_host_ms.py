"""Host ms per fleet tick in the guidance stack's own spans
(`fleet.waypoints`, `fleet.perceive`, `fleet.pack`, `fleet.plant`,
`fleet.log`, in `sim/fleet.py::FleetMissionEngine.tick`; no sync in
them), summed per tick (the spans of one tick share an id) and averaged
over the window's ticks that start on a drained device
(`_trace.drained`).  In the others the host runs a tick or more ahead of
the device, and the stack's launches wait for the launch queue to take
them: their host time is then the device's pace, not the stack's cost."""

from port_bench.metrics._trace import MS, by_id, drained, trace_of

GUIDANCE = ("fleet.waypoints", "fleet.perceive", "fleet.pack",
            "fleet.plant", "fleet.log")


def read(rec):
    trace = trace_of(rec)
    if trace is None:
        return None
    free = drained(trace, "fleet.tick")
    per_tick = [sum(s["host"][1] - s["host"][0] for s in spans)
                for tid, spans in by_id(trace, GUIDANCE).items()
                if tid in free]
    return MS * sum(per_tick) / len(per_tick) if per_tick else None
