"""The device's idle share between the traced ticks
(`_idle.idle_pct`), in %."""

from port_bench.metrics._idle import idle_pct


def read(rec):
    return idle_pct(rec)
