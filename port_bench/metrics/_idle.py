"""The device's idle share in %: 1 - (the union of each tick's device
interval, from a CUDA event recorded before the tick's first submission
to one after its last) / (the first event to the last).  A tick's own
gaps between kernels count as busy."""


def idle_pct(rec):
    bw = rec.get("device_busy_window_ms")
    if not bw or bw[1] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - bw[0] / bw[1])
