"""CUDA kernels launched per step (an iteration, a frame): the kernels in
the traced window over the steps it ran."""


def read(tr, work):
    n = len(tr.kernels())
    return n / tr.steps if n else None
