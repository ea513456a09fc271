"""Tracing and timing hooks (gslm_tpu/utils/profiling.py).

- ``span(name)``: the program's spans at its layer boundaries
  (``gslm.train_step``, ``gslm.render``, ``gslm.preprocess``,
  ``gslm.front_end`` and its ``.cell_masks``, ``.duplicate``, ``.sort``,
  ``.gather``, ``gslm.composite_fwd``, ``gslm.loss``, ``gslm.backward``,
  ``gslm.composite_bwd``, ``gslm.adam``): recorded functions while a
  ``torch.profiler`` records, so they share its timeline with the CUDA
  runtime calls and the kernels; otherwise a shared no-op.
- ``trace(dir)``: a ``torch.profiler`` trace of the block (host and CUDA
  activity), written to ``dir`` as a Chrome trace (Perfetto opens it); the
  trainer's ``--profile_dir``. It holds the program's spans.
- ``IterTimer``: wall-clock per-iteration timer with an EMA, on the host
  clock as the JAX package's is (no device sync of its own).
- ``enable_nan_debugging()``: autograd anomaly mode.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The span ``name`` around a block while a ``torch.profiler`` records
    (autograd's worker threads included), else a shared no-op context, at
    the cost of one read of the profiler's state.

    The span is a recorded function (``_RecordFunctionFast``), not a
    ``record_function`` user annotation: the profiler copies each user
    annotation onto the device's rows of its trace, where a PyTorch whose
    events do not say their kind (2.11) shows the copy as one more kernel.
    A recorded function stays on the host's rows, so the device's rows hold
    the device's own work alone."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where
    available) and write ``<log_dir>/trace_<pid>_<n>.json``."""
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


def enable_nan_debugging():
    """``--detect_anomaly``: autograd anomaly mode (the reference's own,
    train.py:267,285), which raises at the first backward op that
    produces a NaN."""
    torch.autograd.set_detect_anomaly(True)
