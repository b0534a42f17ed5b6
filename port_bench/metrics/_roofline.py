"""K1's share of its roofline from the profiler's kernels: the sum of each
launch's bound (its operations and bytes from `vendor/work.py` at the
launch's shapes, over the published H100 peaks) divided by the sum of the
launches' device time, in %.  Only the launches the profiler reports
count, in both sums (it does not see kernels inside conditional graph
nodes); none reported gives nothing."""

from port_bench.vendor.work import bound_s, riccati_work

K1 = "riccati_lanes_kernel"


def k1_share(rec):
    kernels, shape = rec.get("kernels"), rec.get("k1_shape")
    if not kernels or shape is None:
        return None
    times = [(e - s) * 1e-6 for name, s, e in kernels if K1 in name]
    if not times or sum(times) <= 0:
        return None
    N, nx, nu, L = shape
    nbytes, flops = riccati_work(N, nx, nu, L, 4)
    return 100.0 * bound_s(nbytes, flops, 4) * len(times) / sum(times)
