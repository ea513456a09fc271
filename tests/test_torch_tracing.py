"""The port's spans (``utils/profiling.span``) at its layer boundaries.

Under ``torch.profiler`` one ``train_step`` and one ``render`` on a tiny
scene hold every span of the table below, each inside the parent it
names; ``gslm.composite_bwd`` lies inside ``gslm.backward``'s interval,
and on the card it is recorded on autograd's worker thread, not on the
caller's (on the CPU autograd runs the backward on the caller's thread).
With no profiler ``span`` never reaches the profiler's recorded function:
made to raise, the step and the render still run and give the same
outputs. The spans are recorded functions, not user annotations, so the
profiler puts no copy of them on the device's rows. Runs
without JAX, so the card test runs where only PyTorch is installed:

    python -m pytest tests/test_torch_tracing.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gslm_tpu_torch.config import OptimizationParams
from gslm_tpu_torch.models.gaussians import GaussianAux
from gslm_tpu_torch.optim import init_adam
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.renderer import render
from gslm_tpu_torch.train import train_step
from gslm_tpu_torch.utils import profiling
from gslm_tpu_torch.utils.synthetic import random_gaussians, ring_camera_batch
from torch_threads import one_thread  # noqa: F401 (autouse)

# every span and the span it lies in (None: outermost)
PARENT = {
    "gslm.train_step": None,
    "gslm.render": "gslm.train_step",
    "gslm.preprocess": "gslm.render",
    "gslm.front_end": "gslm.render",
    "gslm.front_end.cell_masks": "gslm.front_end",
    "gslm.front_end.duplicate": "gslm.front_end",
    "gslm.front_end.sort": "gslm.front_end",
    "gslm.front_end.gather": "gslm.front_end",
    "gslm.composite_fwd": "gslm.render",
    "gslm.loss": "gslm.train_step",
    "gslm.backward": "gslm.train_step",
    "gslm.composite_bwd": "gslm.backward",
    "gslm.adam": "gslm.train_step",
}
RENDER_SPANS = {k for k, v in PARENT.items()
                if v not in (None, "gslm.train_step", "gslm.backward")
                } | {"gslm.render"}


def _scene(device):
    params = random_gaussians(np.random.default_rng(0), n=300, capacity=320,
                              num_images=2, spread=1.5, device=device)
    cam = ring_camera_batch(1, 48, 64, device=device)
    return params, cam


def _step(params, cam):
    """One Adam iteration; returns its metrics and the updated groups."""
    dev = params.xyz.device
    _, _, _, m = train_step(
        params, GaussianAux.zeros(params.capacity, device=dev),
        init_adam(params), cam, torch.zeros(3, device=dev), 100, 1.0, 0.0,
        rcfg=RasterConfig(dup_capacity=1 << 14), opt=OptimizationParams(),
        active_sh_degree=3, use_exp=False, sparse_adam=False,
        update_stats=True)
    return m, {g: t.detach().clone() for g, t in params.groups().items()}


def _render(params, cam):
    with torch.no_grad():
        return render(params, cam.view(0),
                      torch.zeros(3, device=params.xyz.device),
                      config=RasterConfig(dup_capacity=1 << 14))


def _spans(prof, on=torch.autograd.DeviceType.CPU) -> list:
    """``(name, start, end, thread)`` of the program's spans on the host's
    rows (``on`` the device's: their copies there), by start."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("gslm.") and e.device_type() == on]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, s):
    """The innermost other span whose interval holds ``s``'s."""
    inside = [p for p in spans if p is not s and p[1] <= s[1]
              and s[2] <= p[2] and (p[1], -p[2]) <= (s[1], -s[2])]
    return max(inside, key=lambda p: (p[1], -p[2]))[0] if inside else None


def _traced(fn, *args, on=torch.autograd.DeviceType.CPU):
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn(*args)
    return _spans(prof, on)


def test_train_step_holds_every_span_nested():
    params, cam = _scene("cpu")
    spans = _traced(_step, params, cam)
    assert {s[0] for s in spans} == set(PARENT)
    for s in spans:
        assert _parent(spans, s) == PARENT[s[0]], s[0]
    (bwd,) = [s for s in spans if s[0] == "gslm.backward"]
    (cbwd,) = [s for s in spans if s[0] == "gslm.composite_bwd"]
    assert bwd[1] <= cbwd[1] and cbwd[2] <= bwd[2]


def test_render_holds_its_spans_nested():
    params, cam = _scene("cpu")
    spans = _traced(_render, params, cam)
    assert {s[0] for s in spans} == RENDER_SPANS
    for s in spans:
        want = None if s[0] == "gslm.render" else PARENT[s[0]]
        assert _parent(spans, s) == want, s[0]


def test_no_profiler_never_reaches_the_recorder(monkeypatch):
    params, cam = _scene("cpu")
    want_img = _render(params, cam)
    want_m, want_groups = _step(params, cam)

    def refuse(name):
        raise AssertionError(f"span {name!r} recorded without a profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("gslm.a") is profiling.span("gslm.b")
    params, cam = _scene("cpu")
    got_img = _render(params, cam)
    got_m, got_groups = _step(params, cam)
    for f in ("render", "invdepth", "radii", "overflow"):
        assert torch.equal(getattr(got_img, f), getattr(want_img, f)), f
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    for g in want_groups:
        assert torch.equal(got_groups[g], want_groups[g]), g


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: autograd runs a CPU backward on the "
                    "caller's thread")
    return torch.device("cuda")


@pytest.mark.cuda
def test_composite_bwd_on_autograd_thread(cuda):
    params, cam = _scene(cuda)
    _step(params, cam)                       # builds the kernels
    spans = _traced(_step, params, cam)
    assert {s[0] for s in spans} == set(PARENT)
    (step,) = [s for s in spans if s[0] == "gslm.train_step"]
    (bwd,) = [s for s in spans if s[0] == "gslm.backward"]
    (cbwd,) = [s for s in spans if s[0] == "gslm.composite_bwd"]
    assert bwd[1] <= cbwd[1] and cbwd[2] <= bwd[2]
    assert cbwd[3] != step[3] == bwd[3]
    # nothing of the spans on the device's rows
    assert _traced(_step, params, cam,
                   on=torch.autograd.DeviceType.CUDA) == []
