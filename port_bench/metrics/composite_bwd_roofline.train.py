"""Backward compositing's share of its roofline: the least time of the
work the traced iterations' views need (``costs.composite_bwd_s``: the
contributing (record, pixel) pairs at a fixed operation count, each splat's
record and cotangent once, each pixel's cotangent once) over the device time
of the kernels that do that role."""

from port_bench import costs
from port_bench.trace import kernel_seconds

# the backward compositor by role: kernel C, or kernel D's walk and sum
KERNELS = ("composite_bwd_kernel", "bucket_walk_kernel", "bucket_sum_kernel")


def read(tr, work):
    t = kernel_seconds(tr, KERNELS)
    if t is None or not work["views"]:
        return None
    return 100.0 * sum(costs.composite_bwd_s(w) for w in work["views"]) / t
