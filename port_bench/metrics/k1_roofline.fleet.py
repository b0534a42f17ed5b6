"""K1's share of its roofline (`_roofline.k1_share`), in %."""

from port_bench.metrics._roofline import k1_share


def read(rec):
    return k1_share(rec)
