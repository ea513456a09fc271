"""The whole Adam iteration's share of the chip's peak: the least time of
its logical work (``costs``: preprocess and SH forward and backward, the
sort of the live records, compositing forward and backward, L1 and SSIM,
Adam over every parameter), summed over the traced iterations, over the
traced window's length."""

from port_bench import costs


def read(tr, work):
    if not tr.device or not work["views"]:
        return None
    least = sum(costs.front_s(w, backward=True) + costs.composite_fwd_s(w)
                + costs.composite_bwd_s(w) + costs.loss_s(w)
                + costs.adam_s(work["params"]) for w in work["views"])
    return 100.0 * least / tr.window_s
