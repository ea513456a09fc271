"""The slice as a whole: gslm_tpu_torch ``batch_render`` / ``render`` and
the eval metrics against gslm_tpu.

JAX renders through its Pallas compositor in interpret mode. Tolerances are
those of tests/test_pallas.py for a random scene (mean |Δ| < 2e-4, at most
1% knife-edge flips above 1e-3); a batched view must equal the single-view
render bit for bit; metrics agree to 1e-5 (SSIM) and 1e-4 dB (PSNR)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu.eval.metrics import evaluate_dir as j_evaluate_dir
from gslm_tpu.renderer import batch_render as j_batch_render
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.eval.metrics import evaluate_dir, pair_metrics
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.renderer import batch_render, render
from gslm_tpu_torch.utils.synthetic import ring_camera_batch
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W, B = 48, 64, 2
BG = np.array([0.2, 0.5, 0.8], np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    jp, _ = j_random_gaussians(rng, n=128, num_images=B)
    exposure = (np.eye(3, 4)[None] + rng.normal(0, 0.1, (B, 3, 4))
                ).astype(np.float32)
    jp = jp.replace(exposure=jnp.asarray(exposure))
    tp = params_from_numpy({g: np.asarray(getattr(jp, g))
                            for g in PARAM_GROUPS}, 3, device="cpu")
    return jp, tp


@pytest.mark.parametrize("use_exp", [False, True])
def test_batch_render_matches_jax(scene, use_exp):
    jp, tp = scene
    a = j_batch_render(jp, j_ring_camera_batch(B, H, W), jnp.asarray(BG),
                       config=JRasterConfig(dup_capacity=1 << 12),
                       impl="pallas", use_trained_exp=use_exp)
    cams = ring_camera_batch(B, H, W, device="cpu")
    with torch.no_grad():   # a serving caller: render is differentiable
        b = batch_render(tp, cams, torch.tensor(BG),
                         config=RasterConfig(dup_capacity=1 << 12),
                         use_trained_exp=use_exp)
    assert b.render.shape == (B, 3, H, W)
    for k in ("render", "invdepth"):
        d = np.abs(getattr(b, k).numpy() - np.asarray(getattr(a, k)))
        assert d.mean() < 2e-4, k
        assert (d > 1e-3).mean() <= 0.01, k
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    for k in ("n_duplicates", "overflow", "max_tile_load"):
        assert int(getattr(b, k)) == int(getattr(a, k)), k

    # view v of the batch is the single-view render of v, bit for bit
    for v in range(B):
        with torch.no_grad():
            one = render(tp, cams.view(v), torch.tensor(BG),
                         config=RasterConfig(dup_capacity=1 << 12),
                         use_trained_exp=use_exp)
        assert torch.equal(one.render, b.render[v])
        assert torch.equal(one.invdepth, b.invdepth[v])


def test_ref_impl_and_unported_impls(scene):
    _, tp = scene
    cams = ring_camera_batch(1, 32, 32, device="cpu")
    cfg = RasterConfig(dup_capacity=1 << 12)
    ref = batch_render(tp, cams, torch.tensor(BG), config=cfg, impl="ref")
    out = batch_render(tp, cams, torch.tensor(BG), config=cfg)
    d = (ref.render - out.render).abs()
    assert float(d.mean()) < 2e-4
    for impl in ("tiled", "pallas"):
        with pytest.raises(NotImplementedError):
            render(tp, cams.view(0), torch.tensor(BG), config=cfg, impl=impl)


@pytest.mark.parametrize("field,value", [
    ("tile_chunk", 64), ("pack", 8), ("mp_route_capacity", 1024),
    ("chunk_rows", 16)])
def test_raster_config_rejects_unread_fields(field, value):
    """A field the port does not read yet raises instead of being ignored;
    ``mp_route_capacity``, the model axis's exchange capacity, is read
    (``parallel/model_raster.py``) and accepted."""
    if field == "mp_route_capacity":
        assert RasterConfig(**{field: value}).mp_route_capacity == value
    else:
        with pytest.raises(NotImplementedError, match=field):
            RasterConfig(**{field: value})
    assert not hasattr(RasterConfig(), "max_per_tile")


def test_metrics_match_jax_evaluate_dir(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(5)
    renders, gts = [], []
    for sub in ("renders", "gt"):
        os.makedirs(tmp_path / sub)
    for i in range(2):
        g = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        r = np.clip(g.astype(int) + rng.integers(-20, 21, g.shape), 0,
                    255).astype(np.uint8)
        Image.fromarray(r).save(tmp_path / "renders" / f"{i:05d}.png")
        Image.fromarray(g).save(tmp_path / "gt" / f"{i:05d}.png")
        renders.append(r)
        gts.append(g)
    want, want_views = j_evaluate_dir(str(tmp_path), use_lpips=False)
    got, got_views = evaluate_dir(str(tmp_path), device="cpu")
    assert got["LPIPS"] is None
    assert abs(got["SSIM"] - want["SSIM"]) < 1e-5
    assert abs(got["PSNR"] - want["PSNR"]) < 1e-4
    assert got_views["SSIM"].keys() == want_views["SSIM"].keys()

    r = torch.tensor(renders[0].transpose(2, 0, 1) / 255.0, dtype=torch.float32)
    g = torch.tensor(gts[0].transpose(2, 0, 1) / 255.0, dtype=torch.float32)
    s, p = pair_metrics(r, g)
    assert abs(float(s) - want_views["SSIM"]["00000.png"]) < 1e-5
    assert abs(float(p) - want_views["PSNR"]["00000.png"]) < 1e-4


def test_evaluate_dir_takes_use_lpips_positionally(tmp_path, capsys):
    """``evaluate_dir(dir, use_lpips)`` as the JAX package's is called;
    LPIPS is null either way, with a note when it was asked for."""
    from PIL import Image
    rng = np.random.default_rng(6)
    for sub in ("renders", "gt"):
        os.makedirs(tmp_path / sub)
        Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
                        ).save(tmp_path / sub / "00000.png")
    want, _ = j_evaluate_dir(str(tmp_path), False)
    got, views = evaluate_dir(str(tmp_path), False, device="cpu")
    assert got["LPIPS"] is None and views["LPIPS"] == {}
    assert abs(got["PSNR"] - want["PSNR"]) < 1e-4
    assert "LPIPS" not in capsys.readouterr().out
    again, _ = evaluate_dir(str(tmp_path), True, device="cpu")
    assert again == got
    assert "LPIPS" in capsys.readouterr().out
