"""The whole viewer frame's share of the chip's peak: the least time of
its logical work (``costs``: preprocess and SH, the sort of the live
records, forward compositing, the frame's scaling), summed over the traced
frames, over the traced window's length."""

from port_bench import costs


def read(tr, work):
    if not tr.device or not work["views"]:
        return None
    least = sum(costs.front_s(w, backward=False) + costs.composite_fwd_s(w)
                + costs.frame_s(w) for w in work["views"])
    return 100.0 * least / tr.window_s
