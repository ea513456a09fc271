"""The join of device ops to the program's spans (``port_bench.spans``) and
the readers that read it, on a synthetic event list run through the
trace's own ``from_events``: two host threads, correlation ids, a kernel
launched from autograd's worker thread inside ``gslm.composite_bwd`` and
one outside it; and every existing reading the same whether or not the
events hold the program's spans, on a PyTorch whose events say their kind
and on one whose events do not (2.11)."""

from __future__ import annotations

import io
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from port_bench import run, spans
from port_bench.trace import device_ops, from_events, idle_gaps

REPO = Path(__file__).resolve().parents[2]
MAIN, WORKER = 11, 12
BWD = "void composite_bwd_kernel<true>(float const*, int const*, int)"
ELEM = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::AUnaryFunctor<float>>(int, float*)")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


class Bare:
    """The part of a kineto event that the trace and the join read, on a
    PyTorch whose events do not say their kind."""

    def __init__(self, name, kind, start, end, corr=0, thread=MAIN):
        self._v = (name, kind, start, end, corr, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return DeviceType.CUDA if self._v[1] in DEVICE else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


class Event(Bare):
    """A kineto event that says its kind."""

    def activity_type(self):
        return self._v[1]


def events(with_spans: bool, kind=Event) -> list:
    """Two steps' window, 0-1000 ns. With spans: the program's around the
    calls on the main thread (recorded functions, so host ops), and
    ``gslm.composite_bwd`` on the worker thread while the main thread waits
    in ``gslm.backward``."""
    def launch(corr, at, op, op_kind="kernel", call="cudaLaunchKernel",
               thread=MAIN):
        # a runtime call at ``at`` and the device op ``op`` = (name, start,
        # end) it enqueued, tied by ``corr``
        name, s, e = op
        return [kind(call, "cuda_runtime", at, at + 5, corr, thread),
                kind(name, op_kind, s, e, corr)]

    ev = [kind("bench_window", "user_annotation", 0, 1000),
          kind("train_step", "user_annotation", 0, 990),
          kind("aten::mul", "cpu_op", 90, 310)]
    ev += launch(1, 20, (ELEM, 30, 100))
    ev += launch(2, 40, ("Memcpy DtoH (Device -> Pageable)", 150, 200),
                 "gpu_memcpy", "cudaMemcpyAsync")
    ev.append(kind("cudaStreamSynchronize", "cuda_runtime", 46, 200, 3))
    ev += launch(4, 430, (BWD, 440, 540), thread=WORKER)
    ev += launch(5, 650, (ELEM, 660, 700), thread=WORKER)
    ev += launch(6, 920, (ELEM, 930, 960))
    if with_spans:
        for name, s, e, t in (("gslm.train_step", 5, 985, MAIN),
                              ("gslm.front_end", 10, 300, MAIN),
                              ("gslm.backward", 400, 900, MAIN),
                              ("gslm.composite_bwd", 420, 590, WORKER),
                              ("gslm.adam", 910, 970, MAIN)):
            ev.append(kind(name, "cpu_op", s, e, thread=t))
    return sorted(ev, key=lambda e: e.start_ns())


def _read(name, tr):
    return run.reader(REPO, name)(tr, {"views": [], "params": 0, "steps": 2})


@pytest.mark.parametrize("kind", [Event, Bare])
def test_join_puts_each_op_under_the_spans_around_its_call(kind):
    tr = from_events(events(True, kind), 2)
    by_op = {(d[0], d[2]): st for d, st in zip(tr.device, spans.join(tr))}
    step, fe = "gslm.train_step", "gslm.front_end"
    assert by_op[(ELEM, 30)] == (step, fe)
    assert by_op[("Memcpy DtoH (Device -> Pageable)", 150)] == (step, fe)
    # autograd's worker thread: inside its own span, and outside it under
    # the span the caller waits in
    assert by_op[(BWD, 440)] == (step, "gslm.backward", "gslm.composite_bwd")
    assert by_op[(ELEM, 660)] == (step, "gslm.backward")
    assert by_op[(ELEM, 930)] == (step, "gslm.adam")
    assert spans.calls(tr) == spans.correlated(events(True, kind), tr)


def test_join_refuses_ops_and_calls_that_do_not_pair_up_in_number():
    ev = [e for e in events(True) if e.correlation_id() != 6
          or e.activity_type() == "kernel"]            # a launch lost
    tr = from_events(ev, 2)
    assert spans.join(tr) is None
    assert spans.span_seconds(tr, "gslm.front_end") is None
    # the device's clock read 15 ns behind the host's: the kernel launched
    # at 430 reads as starting at 425, and is joined to that call all the
    # same
    early = [Event(*e._v[:2], e.start_ns() - 15, e.end_ns() - 15,
                   *e._v[4:]) if e.name() == BWD else e
             for e in events(True)]
    tr = from_events(early, 2)
    assert spans.calls(tr) == spans.correlated(early, tr)
    assert spans.span_seconds(tr, "gslm.composite_bwd") == pytest.approx(
        100e-9)


def test_span_seconds_and_idle_by_span():
    tr = from_events(events(True), 2)
    got = {n: spans.span_seconds(tr, n) for n in
           ("gslm.train_step", "gslm.front_end", "gslm.backward",
            "gslm.composite_bwd", "gslm.adam", "gslm.preprocess")}
    assert got == pytest.approx({
        "gslm.train_step": 290e-9, "gslm.front_end": 120e-9,
        "gslm.backward": 140e-9, "gslm.composite_bwd": 100e-9,
        "gslm.adam": 30e-9, "gslm.preprocess": None})
    incl, own = spans.device_by_span(tr)
    assert incl["gslm.backward"] == pytest.approx(140e-9)
    assert own == pytest.approx({"gslm.front_end": 120e-9,
                                 "gslm.composite_bwd": 100e-9,
                                 "gslm.backward": 40e-9, "gslm.adam": 30e-9})
    # gaps 0-30 and 100-150 in the front end, 200-440 and 960-1000 in the
    # step, 540-660 and 700-930 under backward (the worker's span ended)
    assert dict(spans.idle_by_span(tr)) == pytest.approx({
        "gslm.front_end": 80e-9, "gslm.train_step": 280e-9,
        "gslm.backward": 350e-9})
    plain = from_events(events(False), 2)
    assert spans.idle_by_span(plain) == [(spans.OUTSIDE,
                                          pytest.approx(710e-9))]
    assert spans.host_syncs(tr) == spans.host_syncs(plain) == 1
    assert spans.syncs_by_span(tr) == [
        (("gslm.front_end", "cudaStreamSynchronize"), 1)]


def test_report_lines():
    out = io.StringIO()
    spans.report(from_events(events(True), 2), events(True), out)
    text = out.getvalue()
    assert "idle by program span (s): gslm.backward 3.5" in text
    assert "gslm.front_end cudaStreamSynchronize 0.5" in text
    assert "gslm.train_step holds 99.99" in text
    assert "order join against correlation ids: 5 of 5 ops" in text
    out = io.StringIO()
    lost = [e for e in events(True) if e.name() != "cudaMemcpyAsync"]
    spans.report(from_events(lost, 2), lost, out)
    assert "no join; gpu_memcpy 0 calls, 1 ops, kernel 4 calls" in (
        out.getvalue())


def test_readers():
    tr = from_events(events(True), 2)
    assert _read("front_end_ms.train", tr) == pytest.approx(120e-9 * 1e3 / 2)
    assert _read("front_end_ms.serve", tr) == pytest.approx(120e-9 * 1e3 / 2)
    assert _read("adam_ms.train", tr) == pytest.approx(30e-9 * 1e3 / 2)
    assert _read("preprocess_ms.serve", tr) is None
    assert _read("host_syncs.train", tr) == pytest.approx(0.5)
    # the parent's program has no spans: nothing to read, nothing raised
    plain = from_events(events(False), 2)
    for name in ("front_end_ms.train", "preprocess_ms.train",
                 "adam_ms.train"):
        assert _read(name, plain) is None
    assert _read("host_syncs.serve", plain) == pytest.approx(0.5)
    empty = from_events([Event("bench_window", "user_annotation", 0, 9)], 1)
    assert _read("host_syncs.train", empty) is None


@pytest.mark.parametrize("kind", [Event, Bare])
def test_existing_readings_are_the_same_with_spans(kind):
    with_, plain = (from_events(events(s, kind), 2) for s in (True, False))
    assert with_.device == plain.device
    assert device_ops(with_) == device_ops(plain)
    assert with_.busy_s() == plain.busy_s()
    work = {"views": [{"gaussians": 1000, "visible": 900, "splats": 500,
                       "records_aabb": 6000, "records": 5000,
                       "pairs": 20000, "pixels": 3072}] * 2,
            "params": 59000, "steps": 2}
    existing = ("device_idle.train", "launches.serve",
                "composite_bwd_roofline.train",
                "composite_fwd_roofline.serve", "step_mfu.train",
                "step_mfu.serve")
    for name in existing:
        read = run.reader(REPO, name)
        assert read(with_, work) == read(plain, work), name
    # the idle time is the same; a gap's label may now name the span the
    # host most recently entered
    assert sum(t for _, t in idle_gaps(with_)) == pytest.approx(
        sum(t for _, t in idle_gaps(plain)))
