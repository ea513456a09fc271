"""gslm_tpu_torch's eval tools (eval/render_sets.py, eval/metrics.py,
eval/full_eval.py) against gslm_tpu's on the CPU.

From one model directory (the synthetic scene's point-cloud model saved at
iteration 1) both packages render the train and test sets: the same file
tree, the PNGs within 1 LSB (the port's plain compositor and JAX's XLA one
round differently before the +0.5 truncation). ``metrics.evaluate`` on
the same renders: ``results.json`` and ``per_view.json`` with the same
keys, values within 1e-4. ``full_eval`` runs the same command lines with
the port's module names."""

import json
import os
import shutil

import numpy as np
import pytest

import gslm_tpu.config as j_cfg
import gslm_tpu.eval.full_eval as j_full_eval
from gslm_tpu.eval.metrics import evaluate as j_evaluate
from gslm_tpu.eval.render_sets import render_sets as j_render_sets
from gslm_tpu_torch.data.png import read_png
from gslm_tpu_torch.eval import full_eval
from gslm_tpu_torch.eval.metrics import evaluate
from gslm_tpu_torch.eval.render_sets import main as render_sets_main


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The model saved once, copied, and rendered by each package."""
    from gslm_tpu.models.scene import Scene
    from tests.synthetic_scene import build_colmap_scene

    root = tmp_path_factory.mktemp("eval")
    src = build_colmap_scene(str(root / "data"), n_views=6, height=64,
                             width=64)
    base = str(root / "model")
    Scene(src, base, eval_split=True, shuffle=False).save(1)
    with open(os.path.join(base, "cfg_args"), "w") as f:
        json.dump({"source_path": src, "model_path": base, "eval": True}, f)
    out = {}
    for name in ("jax", "port"):
        out[name] = str(root / name)
        shutil.copytree(base, out[name])
    j_render_sets(j_cfg.ModelParams(source_path=src, model_path=out["jax"],
                                    eval=True), -1,
                  tpu=j_cfg.TpuParams(dup_capacity=1 << 12, max_per_tile=128,
                                      tile_chunk=4))
    render_sets_main(["-m", out["port"], "--iteration", "-1",
                      "--dup_capacity", str(1 << 12), "--platform", "cpu"])
    return out


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".png"))


def test_render_sets_writes_jax_tree(rendered):
    tree = _tree(rendered["port"])
    assert tree == _tree(rendered["jax"])
    assert any(p.startswith(os.path.join("test", "ours_1", "renders"))
               for p in tree)
    assert any(p.startswith(os.path.join("train", "ours_1", "gt"))
               for p in tree)
    worst = 0
    for p in tree:
        a = read_png(os.path.join(rendered["port"], p)).astype(int)
        b = read_png(os.path.join(rendered["jax"], p)).astype(int)
        assert a.shape == b.shape, p
        worst = max(worst, int(np.abs(a - b).max()))
    assert worst <= 1, worst


def test_metrics_results_match_jax(rendered, tmp_path):
    """Both packages score the same (JAX-rendered) directory."""
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(rendered["jax"], dirs[name])
    j_evaluate([dirs["jax"]], use_lpips=False)
    evaluate([dirs["port"]], use_lpips=False, device="cpu")
    for fname in ("results.json", "per_view.json"):
        with open(os.path.join(dirs["port"], fname)) as f:
            got = json.load(f)
        with open(os.path.join(dirs["jax"], fname)) as f:
            want = json.load(f)
        assert got.keys() == want.keys() == {"ours_1"}

        def flat(d, prefix=()):
            for k, v in d.items():
                if isinstance(v, dict):
                    yield from flat(v, prefix + (k,))
                else:
                    yield prefix + (k,), v

        got, want = dict(flat(got)), dict(flat(want))
        assert got.keys() == want.keys(), fname
        for k, v in want.items():
            if v is None:
                assert got[k] is None, k
            else:
                assert abs(got[k] - v) <= 1e-4, (k, got[k], v)


def test_full_eval_runs_jax_commands_with_port_modules(monkeypatch,
                                                       tmp_path):
    argv = ["-m360", "/d/360", "-tat", "/d/tat", "-db", "/d/db",
            "--output_path", str(tmp_path / "out"), "--use_lm",
            "--extra_train_args", "--iterations 100"]
    cmds = {}
    for name, mod in (("jax", j_full_eval), ("port", full_eval)):
        got = cmds[name] = []
        monkeypatch.setattr(mod, "run", got.append)
        if name == "jax":
            monkeypatch.setattr("sys.argv", ["full_eval"] + argv)
            mod.main()
        else:
            mod.main(argv)
    swapped = [[a.replace("gslm_tpu.", "gslm_tpu_torch.") for a in c]
               for c in cmds["jax"]]
    assert cmds["port"] == swapped
    assert len(swapped) == 2 * 13 + 1
