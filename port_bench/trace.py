"""The traced window: ``torch.profiler`` events read in memory (nothing is
exported to disk), reduced to device intervals and host spans, and the
readings every per-layer metric shares.

``capture`` profiles a block under a ``bench_window`` annotation; ``Trace``
holds, in nanoseconds of the profiler's clock, the device operations
(kernels, copies, fills) and the host operations (PyTorch ops, the
benchmark's annotations, CUDA runtime calls) that overlap the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np

WINDOW = "bench_window"
# the mix kinds' spans around the calls into the program (``span``)
SPANS = ("train_step", "render", "frame_to_host")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime")
# host events that label nothing the program does
HOST_NOISE = ("Activity Buffer Request",)


@dataclasses.dataclass
class Trace:
    """Device ops ``(name, kind, start, end)`` and host ops ``(name,
    start, end)`` inside ``[t0, t1]``, and the number of steps (iterations,
    frames) the window ran."""

    device: list
    host: list
    t0: int
    t1: int
    steps: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def kernels(self, names=None) -> list:
        """Kernel ops, all or those whose short name is in ``names``."""
        return [d for d in self.device if d[1] == "kernel"
                and (names is None or short_name(d[0]) in names)]

    def busy_intervals(self) -> np.ndarray:
        """The union of the device ops' intervals, clipped to the window:
        (k, 2) int64, sorted and disjoint."""
        iv = sorted((max(s, self.t0), min(e, self.t1))
                    for _, _, s, e in self.device if e > self.t0
                    and s < self.t1)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.array(out, dtype=np.int64).reshape(-1, 2)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9


def short_name(name: str) -> str:
    """A kernel's function name without ``void``, its namespaces, template
    arguments and parameters."""
    full = name
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    base = "".join(out).strip()
    return base.split("::")[-1] or base or full


def span(name: str):
    """A profiler span of the benchmark's own around a call into the
    program (free when no profiler runs)."""
    from torch.profiler import record_function
    return record_function(name)


@contextlib.contextmanager
def capture(box: dict, steps: int):
    """Profile the block (CPU and CUDA activity) under the ``bench_window``
    annotation; on exit, ``box["trace"]`` holds its ``Trace`` of
    ``steps`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    box["trace"] = from_events(prof.profiler.kineto_results.events(), steps)


def _kind(e, cuda) -> str:
    """The event's kineto activity kind; where this PyTorch does not give
    it, a device event is a copy, a fill, a synchronisation or a kernel by
    its name, and a host event a host op."""
    name = e.name()
    if name == WINDOW or name in SPANS:
        return "user_annotation"   # also their copies on the device's row
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != cuda:
        return "cpu_op"
    for prefix, kind in (("Memcpy", "gpu_memcpy"), ("Memset", "gpu_memset")):
        if name.startswith(prefix):
            return kind
    return "cuda_sync" if "Sync" in name else "kernel"


def from_events(events, steps: int) -> Trace:
    """A ``Trace`` from kineto events; the window is the ``bench_window``
    annotation's span."""
    from torch.autograd import DeviceType
    device, host = [], []
    t0 = t1 = None
    for e in events:
        kind = _kind(e, DeviceType.CUDA)
        s, d = e.start_ns(), e.duration_ns()
        if kind in DEVICE_KINDS:
            device.append((e.name(), kind, s, s + d))
        elif kind in HOST_KINDS and e.name() not in HOST_NOISE:
            if e.device_type() == DeviceType.CUDA:
                continue                      # an annotation's device copy
            if e.name() == WINDOW:
                t0, t1 = s, s + d
            else:
                host.append((e.name(), s, s + d))
    if t0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    device = [x for x in device if x[3] > t0 and x[2] < t1]
    host = [x for x in host if x[2] > t0 and x[1] < t1]
    return Trace(device, host, t0, t1, steps)


def idle_gaps(tr: Trace) -> list:
    """``[(label, seconds)]``: the window's device-idle time summed by what
    the host was doing in each gap (the most recently started host op still
    running at the gap's midpoint, or "host idle"), longest first."""
    iv = tr.busy_intervals()
    edges = np.concatenate([[tr.t0], iv.ravel(), [tr.t1]]).reshape(-1, 2)
    gaps = [(int(s), int(e)) for s, e in edges if e > s]
    host = sorted(tr.host, key=lambda h: h[1])
    open_ops, i, totals = [], 0, {}
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(host) and host[i][1] <= mid:
            open_ops.append(host[i])
            i += 1
        while open_ops and open_ops[-1][2] <= mid:
            open_ops.pop()
        label = open_ops[-1][0] if open_ops else "host idle"
        totals[label] = totals.get(label, 0) + (e - s)
    return sorted(((k, v * 1e-9) for k, v in totals.items()),
                  key=lambda kv: -kv[1])


def device_ops(tr: Trace) -> list:
    """``[(name, seconds)]``: device time by op short name, longest first."""
    totals = {}
    for name, kind, s, e in tr.device:
        key = short_name(name) if kind == "kernel" else name
        totals[key] = totals.get(key, 0) + (min(e, tr.t1) - max(s, tr.t0))
    return sorted(((k, v * 1e-9) for k, v in totals.items()),
                  key=lambda kv: -kv[1])


def kernel_seconds(tr: Trace, names) -> float | None:
    """Device seconds of the kernels named ``names`` in the window, or None
    where none ran."""
    ks = tr.kernels(set(names))
    if not ks:
        return None
    return sum(e - s for _, _, s, e in ks) * 1e-9
