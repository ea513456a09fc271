"""Depth-supervised training (``train -d``): gslm_tpu_torch's ``training``
against gslm_tpu's on the CPU, on tests/test_torch_trainer.py's scene with
a folder of 16-bit inverse-depth PNGs (half resolution, grey and RGB) and
a depth_params.json in which one train view's scale is a tenth of the
others' (unreliable: its depth mask is zero and its weight 0).

Both packages run 14 single-view Adam iterations (two density events, an
opacity reset), then 4 iterations of 5-view SGD windows, from the same
command lines, the port with JAX's split noise. Tolerances: the views,
the depth weights (each iteration's exponential schedule, 0 for the
unreliable view), the depth-mask sums and ``alive`` equal; ``depth_l1``
per iteration within 1e-5 relative of JAX's (5.2e-7 measured);
parameters and Adam moments entry by entry as ``_assert_params`` holds
them (0.1 lr). The unreliable view's depth L1 is exactly 0 alone, and in
a window its depth mask sums to 0 while the others' do not."""

import json
import math
import os
import shutil
import sys

import numpy as np
import pytest

import gslm_tpu.train as j_train
from gslm_tpu_torch import train as t_train
from gslm_tpu_torch.data.png import write_png
from tests.test_torch_trainer import (ITERS, LINEAGE_ROWS, _argv,  # noqa: F401
                                      _assert_params, _jax_noise, _keep_stdout,
                                      scene_dir)

UNRELIABLE = "view_003.png"     # COLMAP image names keep the extension
REL = 1e-5


@pytest.fixture(scope="module")
def depth_scene(scene_dir, tmp_path_factory):
    """The trainer tests' 8-view 64x64 scene with depths/ and
    sparse/0/depth_params.json."""
    src = str(tmp_path_factory.mktemp("depth") / "src")
    shutil.copytree(scene_dir, src)
    os.makedirs(os.path.join(src, "depths"))
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    params = {}
    for i in range(8):
        name = f"view_{i:03d}"
        mono = 0.3 + 0.2 * np.sin(3 * xx + i) * np.cos(2 * yy - 0.5 * i)
        u16 = np.round(mono * 65535).astype(np.uint16)
        if i % 2:       # RGB: the tools take blue, OpenCV's first channel
            u16 = np.stack([u16 // 3, u16 // 2, u16], -1)
        write_png(os.path.join(src, "depths", name + ".png"), u16)
        params[name] = {"scale": 0.1 if name + ".png" == UNRELIABLE
                        else 0.8 + 0.05 * i, "offset": 0.01 * (i - 3)}
    with open(os.path.join(src, "sparse", "0", "depth_params.json"),
              "w") as f:
        json.dump(params, f)
    return src


class _DepthRecord:
    """Per Adam attempt: the view names, the depth weight, the depth L1
    and each view's depth-mask sum."""

    def __init__(self, monkeypatch, module, step_name):
        self.rows = []
        real = getattr(module, step_name)
        jax_side = step_name == "train_step"

        def step(params, *a, **k):
            cam, dw = (a[2], a[6]) if jax_side else (a[0], a[2])
            out = real(params, *a, **k)
            d = out[3]["depth_l1"] if jax_side else out[2]
            mask = np.asarray(cam.depth_mask).reshape(
                cam.depth_mask.shape[0], -1).sum(1)
            self.rows.append((np.asarray(cam.exposure_idx).tolist(),
                              float(dw), float(d), mask.tolist()))
            return out

        monkeypatch.setattr(module, step_name, step)


def _runs(monkeypatch, argv, sgd):
    """JAX's and the port's ``training`` on ``argv`` (SGD windows with
    ``sgd``): (record, scene, params, aux, opt_state) each."""
    out = []
    for module, name in ((j_train, "train_step"),
                         (t_train, "loss_and_grads")):
        args = module.build_parser().parse_args(argv)
        args.save_iterations.append(args.iterations)
        args.sgd_batch = sgd
        with monkeypatch.context() as m:
            if module is t_train:
                m.setattr(t_train, "split_noise", _jax_noise())
            rec = _DepthRecord(m, module, name)
            out.append((rec,) + tuple(module.training(args)))
    return out


@pytest.fixture(scope="module")
def depth_runs(depth_scene, tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_runs")
    mp = pytest.MonkeyPatch()
    saved = sys.stdout
    try:
        loop = _runs(mp, _argv(depth_scene, str(root / "loop")) + [
            "-d", "depths"], sgd=False)
        sgd = _runs(mp, _argv(depth_scene, str(root / "sgd"), iterations=4,
                              test_iterations=None, save_iterations=[4],
                              checkpoint_iterations=None)
                    + ["-d", "depths", "--num_images", "5"], sgd=True)
    finally:
        sys.stdout = saved
        mp.undo()
    return loop, sgd


def _check_depth_rows(jrec, trec, names):
    assert len(trec.rows) == len(jrec.rows)
    for (jv, jdw, jd, jm), (tv, tdw, td, tm) in zip(jrec.rows, trec.rows):
        assert tv == jv
        assert math.isclose(tdw, jdw, rel_tol=1e-12, abs_tol=0)
        assert abs(td - jd) <= REL * abs(jd), (tv, td, jd)
        assert tm == jm
        for v, m in zip(tv, tm):
            assert (m == 0) == (names[v] == UNRELIABLE), (names[v], m)


def test_depth_loop_matches_jax(depth_runs):
    """14 single-view iterations: the unreliable view trains without a
    depth term (weight 0, depth L1 exactly 0), every other iteration with
    the schedule's weight, and the state matches JAX's."""
    (jrec, jscene, *_), (trec, tscene, *_) = jrun, trun = depth_runs[0]
    names = [c.image_name for c in tscene.get_train_cameras()]
    assert names == [c.image_name for c in jscene.get_train_cameras()]
    assert [c.depth_reliable for c in tscene.get_train_cameras()] == [
        n != UNRELIABLE for n in names]
    _check_depth_rows(jrec, trec, names)
    assert len(trec.rows) == ITERS
    seen = [names[v[0]] for v, *_ in trec.rows]
    assert UNRELIABLE in seen
    for (v, dw, d, _), n in zip(trec.rows, seen):
        assert (dw == 0 and d == 0) if n == UNRELIABLE else (dw > 0 < d)
    assert trun[4].step == int(jrun[4].step) == ITERS
    _assert_params(jrun, trun, lineage_rows=LINEAGE_ROWS)


def test_depth_sgd_windows_match_jax(depth_runs):
    """4 iterations of 5-view windows: the unreliable view's depth mask is
    zeroed inside its window, the window keeps its depth term from the
    others, and the state matches JAX's."""
    (jrec, jscene, *_), (trec, tscene, *_) = jrun, trun = depth_runs[1]
    names = [c.image_name for c in tscene.get_train_cameras()]
    _check_depth_rows(jrec, trec, names)
    assert [len(v) for v, *_ in trec.rows] == [5] * 4
    with_it = [r for r in trec.rows
               if UNRELIABLE in [names[v] for v in r[0]]]
    assert with_it, "no window held the unreliable view"
    assert all(dw > 0 and d > 0 for _, dw, d, _ in trec.rows)
    assert trun[4].step == int(jrun[4].step) == 4
    _assert_params(jrun, trun)
