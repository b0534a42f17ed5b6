"""Stall-escalation IPM iterations per lane tick: the sum of
`LaneRTISolver.last_esc_iters` (a device counter) over the traced ticks,
divided by their count."""


def read(rec):
    n = rec.get("esc_ticks")
    return rec["esc_iters"] / n if n else None
