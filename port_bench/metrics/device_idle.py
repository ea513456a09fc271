"""Share of the traced window in which no operation (kernel, copy, fill)
ran on the device: 100 × (1 − busy / window), busy the union of the device
operations' intervals from ``torch.profiler``."""


def read(tr, work):
    if not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
