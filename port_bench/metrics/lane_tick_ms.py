"""Device ms per lane-engine tick: CUDA events around each captured
`LaneRTISolver.step_fn` replay, summed over the traced ticks and divided
by their count."""


def read(rec):
    ms = rec.get("lane_tick_ms")
    return sum(ms) / len(ms) if ms else None
