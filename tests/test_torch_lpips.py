"""gslm_tpu_torch's LPIPS (eval/lpips.py), its use in eval/metrics.py and
the weight export (tools/export_lpips_weights.py) against gslm_tpu's.

A random-weight npz with the real file's shapes (seeded, as
tests/test_eval_tools.py writes it; ``chip_smoke.write_lpips_weights``)
serves both packages. Tolerances:
LPIPS within 1e-5 relative of JAX's (2.8e-7 measured; both in float32 on
the CPU; XLA's and PyTorch's convolutions sum in different orders);
``lpips(x, x)``
exactly 0; ``evaluate_dir`` within 1e-5 relative of JAX's per view and in
summary (SSIM and PSNR as tests/test_torch_render.py holds them); the
exported npz equal array for array."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu.eval import lpips as j_lpips
from gslm_tpu.eval.metrics import evaluate_dir as j_evaluate_dir
from gslm_tpu.tools import export_lpips_weights as j_export
from gslm_tpu_torch.data.png import write_png
from gslm_tpu_torch.eval import lpips
from gslm_tpu_torch.eval.metrics import evaluate_dir, main as metrics_main
from gslm_tpu_torch.tools import export_lpips_weights as export
from chip_smoke import write_lpips_weights
from torch_threads import one_thread  # noqa: F401 (autouse)

REL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_lpips_weights(str(tmp_path_factory.mktemp("lpips")
                                   / "lpips.npz"))


def test_lpips_matches_jax(weights):
    """Two pairs at 64x96 in one batch."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 3, 64, 96)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = np.asarray(j_lpips.lpips(jnp.asarray(a), jnp.asarray(b),
                                    weight_path=weights))
    got = lpips.lpips(torch.tensor(a), torch.tensor(b), weight_path=weights)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=0)
    assert np.all(want > 0)


def test_lpips_of_an_image_with_itself_is_zero(weights):
    x = torch.tensor(np.random.default_rng(2).uniform(
        0, 1, (1, 3, 40, 56)).astype(np.float32))
    assert float(lpips.lpips(x, x.clone(), weight_path=weights)[0]) == 0.0


def test_lpips_weights_and_paths(weights, monkeypatch, tmp_path):
    monkeypatch.setenv("GSLM_LPIPS_WEIGHTS", weights)
    assert lpips.default_weight_path() == j_lpips.default_weight_path() \
        == weights
    assert lpips.available() and lpips.available(weights)
    missing = str(tmp_path / "none.npz")
    assert not lpips.available(missing)
    monkeypatch.delenv("GSLM_LPIPS_WEIGHTS")
    assert lpips.default_weight_path() == os.path.join(
        os.path.dirname(lpips.__file__), "lpips_vgg16.npz")
    convs, lins = lpips._load_weights(weights)
    model = lpips.LPIPS(weights)
    # HWIO in the file, OIHW in the module
    assert model.conv0_W.shape == (64, 3, 3, 3)
    np.testing.assert_array_equal(model.conv4_W.numpy().transpose(2, 3, 1, 0),
                                  convs[4][0])
    assert [w.shape[0] for w in lins] == [64, 128, 256, 512, 512]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, conv0_W=convs[0][0], conv0_b=convs[0][1])
    with pytest.raises(ValueError, match="unexpected LPIPS weight file"):
        lpips._load_weights(bad)


def _method_dir(root):
    rng = np.random.default_rng(5)
    for sub in ("renders", "gt"):
        os.makedirs(os.path.join(root, sub))
    for i in range(2):
        g = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        r = np.clip(g.astype(int) + rng.integers(-30, 31, g.shape), 0,
                    255).astype(np.uint8)
        write_png(os.path.join(root, "renders", f"{i:05d}.png"), r)
        write_png(os.path.join(root, "gt", f"{i:05d}.png"), g)
    return root


def test_evaluate_dir_with_lpips_matches_jax(weights, monkeypatch, tmp_path,
                                             capsys):
    d = _method_dir(str(tmp_path / "ours_1"))
    monkeypatch.setenv("GSLM_LPIPS_WEIGHTS", weights)
    want, want_views = j_evaluate_dir(d, True)
    got, views = evaluate_dir(d, True, device="cpu")
    assert got.keys() == want.keys() and views.keys() == want_views.keys()
    assert got["LPIPS"] is not None and got["LPIPS"] > 0
    for k in ("SSIM", "PSNR", "LPIPS"):
        assert abs(got[k] - want[k]) <= REL * abs(want[k]), k
        assert views[k].keys() == want_views[k].keys()
        for n in views[k]:
            assert abs(views[k][n] - want_views[k][n]) \
                <= REL * abs(want_views[k][n]), (k, n)
    assert "weights not found" not in capsys.readouterr().out
    # --no_lpips, and no weight file: null with JAX's note
    assert evaluate_dir(d, False, device="cpu")[0]["LPIPS"] is None
    monkeypatch.setenv("GSLM_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    none, none_views = evaluate_dir(d, True, device="cpu")
    assert none["LPIPS"] is None and none_views["LPIPS"] == {}
    out = capsys.readouterr().out
    assert "LPIPS weights not found at" in out and "reporting LPIPS: null" \
        in out


def test_metrics_main_reports_lpips(weights, monkeypatch, tmp_path):
    import json
    model = tmp_path / "model"
    _method_dir(str(model / "test" / "ours_7"))
    monkeypatch.setenv("GSLM_LPIPS_WEIGHTS", weights)
    metrics_main(["-m", str(model), "--platform", "cpu"])
    with open(model / "results.json") as f:
        res = json.load(f)["ours_7"]
    assert res["LPIPS"] is not None and res["LPIPS"] > 0
    metrics_main(["-m", str(model), "--platform", "cpu", "--no_lpips"])
    with open(model / "results.json") as f:
        assert json.load(f)["ours_7"]["LPIPS"] is None


def _stubs(monkeypatch):
    """torchvision (a VGG16 ``features`` stack of small seeded
    convolutions) and torch.hub (the heads' state dict), in sys.modules."""
    gen = torch.Generator().manual_seed(3)
    layers, cin = [], 3
    for c in lpips.VGG16_CFG:
        if c == "M":
            layers.append(torch.nn.MaxPool2d(2, 2))
            continue
        conv = torch.nn.Conv2d(cin, c // 16, 3, padding=1)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
        layers += [conv, torch.nn.ReLU(inplace=True)]
        cin = c // 16
    tv = types.ModuleType("torchvision")
    tv.models = types.SimpleNamespace(
        VGG16_Weights=types.SimpleNamespace(IMAGENET1K_V1="imagenet"),
        vgg16=lambda weights: types.SimpleNamespace(
            features=torch.nn.Sequential(*layers)))
    state = {f"lin{j}.model.1.weight":
             torch.rand((1, c, 1, 1), generator=gen)
             for j, c in enumerate([4, 8, 16, 32, 32])}
    hub = types.ModuleType("torch.hub")
    hub.load_state_dict_from_url = lambda url, map_location, progress: state
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    monkeypatch.setitem(sys.modules, "torch.hub", hub)
    monkeypatch.setattr(torch, "hub", hub)


def test_export_matches_jax(tmp_path, monkeypatch, capsys):
    _stubs(monkeypatch)
    j_export.main(str(tmp_path / "jax.npz"))
    export.main(str(tmp_path / "port.npz"))
    assert export.LIN_URL == j_export.LIN_URL
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    assert len(got.files) == 13 * 2 + 5
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert capsys.readouterr().out.count("31 arrays") == 2
