"""Forward compositing's share of its roofline: the least time of the work
the traced frames' views need (``costs.composite_fwd_s``: the contributing
(record, pixel) pairs at a fixed operation count, each splat's record once,
each output pixel once) over the device time of the kernels that do that
role."""

from port_bench import costs
from port_bench.trace import kernel_seconds

# the forward compositor by role: kernel A
KERNELS = ("composite_fwd_kernel",)


def read(tr, work):
    t = kernel_seconds(tr, KERNELS)
    if t is None or not work["views"]:
        return None
    return 100.0 * sum(costs.composite_fwd_s(w) for w in work["views"]) / t
