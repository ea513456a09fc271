"""The program's spans in a traced window: each device op joined to the
``gslm.*`` spans open around the CUDA runtime call that enqueued it, and
what the per-layer metrics of the program's layers read from that join.

A ``Trace`` keeps host ops as ``(name, start, end)`` and device ops as
``(name, kind, start, end)``, without the profiler's correlation ids and
thread ids. The join finds each op's call by order instead: the program
enqueues every kernel, copy and fill on one stream, which runs them in the
order they were enqueued, and a traced window starts on a drained device
and ends with the host's read of the last step's flag. So the k-th kernel
of the window is the k-th kernel launch in it, and likewise the k-th copy
and the k-th fill. Where the counts differ there is no join (None). The
order of an op against its call is not tested: the profiler maps the
device's clock onto the host's with an offset that can reach tens of
microseconds, so an op can read as starting before the call that enqueued
it. The spans of a call are the program's host spans whose interval holds
its start, outer first, on any thread: autograd's worker thread launches
the backward while the caller waits inside ``gslm.backward``, so those
calls fall under that span too.

    python3 -m port_bench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell traced (``port_bench.run``, ``--trace 1``) and prints to
standard error, after its result line, the traced window, busy time and
host syncs a step, the idle time, host syncs and device time by program
span, and the join held against the profiler's correlation ids.
"""

from __future__ import annotations

import re
import sys

import numpy as np

PREFIX = "gslm."
OUTSIDE = "outside the program"
# the CUDA API calls (cuda* and cu*) that enqueue a device op, by its kind
ENQUEUES = (("kernel", re.compile(r"cu(da)?Launch(Cooperative)?Kernel")),
            ("gpu_memcpy", re.compile(r"cu(da)?Memcpy")),
            ("gpu_memset", re.compile(r"cu(da)?Memset")))
# the calls that block the host until the device has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def enqueued_kind(call: str) -> str | None:
    """The kind of device op the runtime call ``call`` enqueues, if any."""
    for kind, pattern in ENQUEUES:
        if pattern.match(call):
            return kind
    return None


def program_spans(tr) -> list:
    """The program's spans ``(name, start, end)`` in the window, outer
    first."""
    return sorted((h for h in tr.host if h[0].startswith(PREFIX)),
                  key=lambda h: (h[1], -h[2]))


def _by_kind(tr) -> dict:
    """{kind: (the starts of the calls that enqueue that kind, sorted; the
    indices of ``tr.device``'s ops of that kind, by start)}."""
    starts, ops = {}, {}
    for name, s, _ in tr.host:
        kind = enqueued_kind(name)
        if kind is not None:
            starts.setdefault(kind, []).append(s)
    for i, (_, kind, _, _) in enumerate(tr.device):
        ops.setdefault(kind, []).append(i)
    return {k: (sorted(starts.get(k, [])),
                sorted(ops.get(k, []), key=lambda i: tr.device[i][2]))
            for k in set(starts) | set(ops)}


def calls(tr) -> list | None:
    """The start of the call that enqueued each op of ``tr.device`` (the
    k-th op of a kind is the k-th call of that kind), or None where the
    counts differ."""
    out = [0] * len(tr.device)
    for starts, idx in _by_kind(tr).values():
        if len(starts) != len(idx):
            return None
        for i, c in zip(idx, starts):
            out[i] = c
    return out


def stacks_at(spans: list, times) -> list:
    """For each time, the names of ``spans`` (outer first) whose interval
    holds it."""
    times = np.asarray(times, dtype=np.int64)
    order = np.argsort(times, kind="stable")
    sorted_t = times[order]
    out = [()] * len(times)
    for name, s, e in spans:
        lo = np.searchsorted(sorted_t, s, side="left")
        hi = np.searchsorted(sorted_t, e, side="right")
        for j in order[lo:hi]:
            out[j] = out[j] + (name,)
    return out


def join(tr) -> list | None:
    """For each op of ``tr.device``, the program's spans around the call
    that enqueued it, outer first; None where the ops and the calls do not
    pair up."""
    at = calls(tr)
    if at is None:
        return None
    return stacks_at(program_spans(tr), at)


def device_by_span(tr) -> tuple[dict, dict] | None:
    """``(inclusive, self)`` device seconds in the window by span name:
    every op counts for each span around its call, and for the innermost
    alone (under ``OUTSIDE`` where none is open); None where the ops and
    calls do not pair up."""
    stacks = join(tr)
    if stacks is None:
        return None
    incl, own = {}, {}
    for op, st in zip(tr.device, stacks):
        t = (min(op[3], tr.t1) - max(op[2], tr.t0)) * 1e-9
        for name in set(st):
            incl[name] = incl.get(name, 0.0) + t
        key = st[-1] if st else OUTSIDE
        own[key] = own.get(key, 0.0) + t
    return incl, own


def span_seconds(tr, name: str) -> float | None:
    """Device seconds, in the window, of the ops enqueued inside the span
    ``name`` (its children's included); None where no op was, or the ops
    and calls do not pair up."""
    got = device_by_span(tr)
    return None if got is None else got[0].get(name)


def span_ms(tr, name: str) -> float | None:
    """``span_seconds`` a step, in ms."""
    s = span_seconds(tr, name)
    return None if s is None else 1e3 * s / tr.steps


def idle_by_span(tr) -> list:
    """``[(span, seconds)]``: the window's device-idle time by the innermost
    program span open at each gap's midpoint, on any thread (``OUTSIDE``
    where none is), longest first."""
    iv = tr.busy_intervals()
    edges = np.concatenate([[tr.t0], iv.ravel(), [tr.t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    label = [st[-1] if st else OUTSIDE
             for st in stacks_at(program_spans(tr), mids)]
    totals = {}
    for name, (s, e) in zip(label, gaps):
        totals[name] = totals.get(name, 0) + int(e - s)
    return sorted(((k, v * 1e-9) for k, v in totals.items()),
                  key=lambda kv: -kv[1])


def host_syncs(tr) -> int:
    """The calls in the window that block the host on the device."""
    return sum(1 for name, _, _ in tr.host if name in SYNCS)


def syncs_by_span(tr) -> list:
    """``[((span, call), count)]``: the host syncs by the innermost program
    span open at the call's start, most first."""
    syncs = [h for h in tr.host if h[0] in SYNCS]
    inside = stacks_at(program_spans(tr), [h[1] for h in syncs])
    counts = {}
    for (name, _, _), st in zip(syncs, inside):
        key = (st[-1] if st else OUTSIDE, name)
        counts[key] = counts.get(key, 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[1])


def correlated(events, tr) -> list:
    """The yardstick the order join is held to: for each op of
    ``tr.device``, the start of the runtime call that the profiler's
    correlation id ties it to (None where there is none)."""
    from torch.autograd import DeviceType
    call_at, op_id = {}, {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            op_id[(e.name(), e.start_ns())] = e.correlation_id()
        elif enqueued_kind(e.name()) is not None:
            call_at[e.correlation_id()] = e.start_ns()
    return [call_at.get(op_id.get((name, s))) for name, _, s, _ in tr.device]


def report(tr, events=None, out=None) -> None:
    """The lines the tool prints for one traced window."""
    out = out or sys.stderr

    def line(head, pairs, unit="s"):
        print(f"{head} ({unit}): " + ", ".join(f"{k} {v!r}" for k, v in
                                               pairs), file=out)

    def per_step(d):
        return sorted(((k, 1e3 * v / n) for k, v in d.items()),
                      key=lambda kv: -kv[1])

    n = tr.steps
    busy = tr.busy_s()
    print(f"traced window a step {1e3 * tr.window_s / n!r} ms, busy a step "
          f"{1e3 * busy / n!r} ms, host syncs a step {host_syncs(tr) / n!r}",
          file=out)
    line("idle by program span", idle_by_span(tr))
    line("host syncs a step by program span and call",
         [(f"{k[0]} {k[1]}", v / n) for k, v in syncs_by_span(tr)], "syncs")
    got = device_by_span(tr)
    if got is None:
        print("device by program span: no join; " + ", ".join(
            f"{kind} {len(starts)} calls, {len(idx)} ops" for kind,
            (starts, idx) in sorted(_by_kind(tr).items())), file=out)
        return
    incl, own = got
    line("device by program span, inclusive, a step", per_step(incl), "ms")
    line("device by program span, self, a step", per_step(own), "ms")
    step = incl.get(PREFIX + "train_step")
    if step:
        print(f"gslm.train_step holds {100 * step / sum(own.values())!r} % "
              f"of the window's device time, its own ops "
              f"{100 * own.get(PREFIX + 'train_step', 0.0) / step!r} % of "
              f"it", file=out)
    if events is None:
        return
    want, at = correlated(events, tr), calls(tr)
    same = sum(1 for a, w in zip(at, want) if a == w)
    print(f"order join against correlation ids: {same} of {len(tr.device)} "
          f"ops have the same call ({sum(w is None for w in want)} without "
          f"a correlated call)", file=out)


def main(argv=None) -> dict:
    from port_bench import run, trace
    argv = list(sys.argv[1:] if argv is None else argv)
    kept = {}
    from_events = trace.from_events

    def keeping(events, steps):
        events = list(events)
        kept["events"], kept["trace"] = events, from_events(events, steps)
        return kept["trace"]

    trace.from_events = keeping
    try:
        out = run.main(argv + ["--trace", "1"])
    finally:
        trace.from_events = from_events
    report(kept["trace"], kept["events"])
    return out


if __name__ == "__main__":
    main()
