"""Tracing and timing hooks (gslm_tpu/utils/profiling.py).

- ``trace(dir)``: a ``torch.profiler`` trace of the block (host and CUDA
  activity), written to ``dir`` as a Chrome trace (Perfetto opens it).
- ``IterTimer``: wall-clock per-iteration timer with an EMA, on the host
  clock as the JAX package's is (no device sync of its own).
- ``device_memory_stats()``: bytes in use and peak bytes per CUDA device.
- ``enable_nan_debugging()``: autograd anomaly mode.
- ``timeit_ms``: median-of-3 wall-clock time per call.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where
    available) and write ``<log_dir>/trace_<pid>_<n>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))


class IterTimer:
    def __init__(self, ema: float = 0.6):
        self._ema = ema
        self._last = time.perf_counter()
        self.value_ms = 0.0

    def tick(self) -> float:
        now = time.perf_counter()
        dt = (now - self._last) * 1e3
        self._last = now
        self.value_ms = (self._ema * self.value_ms + (1 - self._ema) * dt
                         if self.value_ms else dt)
        return dt


def device_memory_stats() -> dict:
    """{"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use"}} per CUDA device;
    ``{}`` without CUDA."""
    import torch
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak")}
    return out


def enable_nan_debugging():
    """``--detect_anomaly``: autograd anomaly mode (the reference's own,
    train.py:267,285), which raises at the first backward op that
    produces a NaN."""
    import torch
    torch.autograd.set_detect_anomaly(True)


def timeit_ms(fn, args, iters: int = 8, warmup: int = 1) -> float:
    """Median of 3 blocks of ``iters`` calls, wall clock per call in ms,
    with one ``torch.cuda.synchronize`` per block (none on the CPU)."""
    import numpy as np
    import torch

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args)
    sync()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        ts.append((time.perf_counter() - t0) / iters)
    return float(np.median(ts)) * 1e3
