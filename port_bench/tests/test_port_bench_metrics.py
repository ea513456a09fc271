"""Each per-layer reader on a synthetic trace, the trace reductions, and
the work counts that the rooflines divide against a count by hand on a
two-tile view."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import costs, run, scene
from port_bench.reference import render as ref
from port_bench.trace import (Trace, device_ops, idle_gaps, kernel_seconds,
                              short_name)
from port_bench.work import view_work

REPO = Path(__file__).resolve().parents[2]
BWD = "void composite_bwd_kernel<true>(float const*, int const*, int)"
FWD = "void composite_fwd_kernel<false>(float const*, float*)"
ELEM = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::AUnaryFunctor<float>>(int, float*)")


def synthetic() -> Trace:
    device = [(BWD, "kernel", 0, 100), ("Memcpy DtoH", "gpu_memcpy", 150, 200),
              (ELEM, "kernel", 300, 400), (FWD, "kernel", 380, 420)]
    host = [("train_step", 0, 990), ("aten::mul", 90, 310)]
    return Trace(device, host, 0, 1000, 2)


WORK = {"views": [{"gaussians": 1000, "visible": 900, "splats": 500,
                   "records_aabb": 6000, "records": 5000, "pairs": 20000,
                   "pixels": 3072}] * 2,
        "params": 59000, "steps": 2}


def test_short_names():
    assert short_name(BWD) == "composite_bwd_kernel"
    assert short_name(ELEM) == "vectorized_elementwise_kernel"
    assert short_name("Memcpy DtoH") == "Memcpy DtoH"


def test_busy_idle_and_gaps():
    tr = synthetic()
    assert tr.busy_s() == pytest.approx(270e-9)       # 0-100, 150-200, 300-420
    assert tr.window_s == pytest.approx(1000e-9)
    gaps = dict(idle_gaps(tr))
    # 100-150 and 200-300 while aten::mul ran; 420-1000 under train_step
    assert gaps == pytest.approx({"aten::mul": 150e-9, "train_step": 580e-9})
    ops = device_ops(tr)
    assert ops[0] == ("composite_bwd_kernel", pytest.approx(100e-9))
    assert kernel_seconds(tr, ("composite_fwd_kernel",)) == pytest.approx(
        40e-9)
    assert kernel_seconds(tr, ("nothing",)) is None


def _read(name, tr, work=WORK):
    return run.reader(REPO, name)(tr, work)


# "later": a cell a later change adds finds the one reader of the base name
@pytest.mark.parametrize("cell", ["train", "serve", "later"])
def test_device_idle_and_launches(cell):
    tr = synthetic()
    assert _read(f"device_idle.{cell}", tr) == pytest.approx(73.0)
    assert _read(f"launches.{cell}", tr) == pytest.approx(1.5)
    empty = Trace([], [], 0, 1000, 2)
    assert _read(f"device_idle.{cell}", empty) is None
    assert _read(f"launches.{cell}", empty) is None


def test_rooflines_and_step_mfu():
    tr = synthetic()
    w = WORK["views"][0]
    bwd = 2 * costs.composite_bwd_s(w)
    assert _read("composite_bwd_roofline.train", tr) == pytest.approx(
        100 * bwd / 100e-9)
    fwd = 2 * costs.composite_fwd_s(w)
    assert _read("composite_fwd_roofline.serve", tr) == pytest.approx(
        100 * fwd / 40e-9)
    train = 2 * (costs.front_s(w, True) + costs.composite_fwd_s(w)
                 + costs.composite_bwd_s(w) + costs.loss_s(w)
                 + costs.adam_s(59000))
    assert _read("step_mfu.train", tr) == pytest.approx(100 * train / 1e-6)
    # a kernel not in the trace, or no views: nothing to read
    assert _read("composite_bwd_roofline.train",
                 Trace([(FWD, "kernel", 0, 9)], [], 0, 10, 1)) is None
    assert _read("step_mfu.serve", tr, dict(WORK, views=[])) is None


def test_costs_take_the_larger_bound():
    w = {"pairs": 10 ** 9, "splats": 1, "pixels": 1}
    assert costs.composite_fwd_s(w) == pytest.approx(
        1e9 * costs.FWD_OPS_PER_PAIR / costs.FP32_FLOPS)
    w = {"pairs": 1, "splats": 10 ** 9, "pixels": 0}
    assert costs.composite_bwd_s(w) == pytest.approx(
        1e9 * 2 * costs.RECORD_BYTES / costs.HBM_BYTES)


def test_work_counts_match_a_count_by_hand():
    """Two 16x16 tiles side by side, three Gaussians: every (record,
    pixel) pair walked in depth order by hand."""
    cam = scene.look_at(4.0, 0.0, 0.0, 60.0, 16, 32)
    g = {"xyz": torch.tensor([[-0.3, 0.05, 0.0], [0.2, -0.1, 0.3],
                              [0.0, 0.0, -0.5]]),
         "features_dc": torch.full((3, 1, 3), 0.3),
         "features_rest": torch.zeros(3, 15, 3),
         "scaling": torch.full((3, 3), math.log(0.15)),
         "rotation": torch.tensor([[1.0, 0, 0, 0]] * 3),
         "opacity": torch.tensor([[3.0], [1.0], [8.0]]),
         "exposure": torch.eye(3, 4)[None]}
    c = ref.camera_dict(**cam, device="cpu")
    got = view_work(g, c)
    sp = ref.project(g, c)
    order = torch.argsort(torch.where(sp["visible"], sp["depth"], torch.inf))
    pairs, used = 0, set()
    for y in range(16):
        for x in range(32):
            t = 1.0
            for i in order.tolist():
                if not sp["visible"][i]:
                    continue
                dx = float(sp["mean2d"][i, 0]) - x
                dy = float(sp["mean2d"][i, 1]) - y
                a_, b_, c_ = (float(v) for v in sp["conic"][i])
                power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
                if power > 0:
                    continue
                alpha = min(0.99, float(sp["opacity"][i]) * math.exp(power))
                if alpha < 1 / 255:
                    continue
                if t * (1 - alpha) < 1e-4:
                    break
                pairs += 1
                used.add(i)
                t *= 1 - alpha
    assert got["pixels"] == 512 and got["gaussians"] == 3
    assert got["visible"] == 3 and got["splats"] == len(used) == 3
    assert got["records"] <= got["records_aabb"] <= 6
    assert got["pairs"] == pairs > 0
    assert np.isfinite(costs.composite_fwd_s(got))
