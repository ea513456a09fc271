"""gslm_tpu_torch kernels on the card, each against its plain PyTorch
version. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Without a card every test skips (CUDA kernels have no CPU mode).
Tolerances: kernel A at the random-scene bounds of the parity tests
(mean |Δ| < 2e-4, at most 1% of values above 1e-3: knife edges at the 1/255
gate); kernel B to 1e-6 (same tap order, no FMA contraction)."""

import numpy as np
import pytest
import torch

from gslm_tpu_torch.ops.blur_cuda import blur_plain, blur_same
from gslm_tpu_torch.ops.projection import preprocess
from gslm_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                               composite_tiles_plain,
                                               tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.ops.ssim import gaussian_taps
from gslm_tpu_torch.renderer import batch_render, render
from gslm_tpu_torch.utils.synthetic import random_gaussians, ring_camera_batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_composite_kernel_matches_plain(cuda):
    params = random_gaussians(np.random.default_rng(0), n=4096, spread=1.5,
                              device=cuda)
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    with torch.no_grad():
        splats = preprocess(params, cam, active_sh_degree=3)
        records, starts, counts, _ = tile_records(splats, 13, 8,
                                                  RasterConfig())
    before = composite_tiles.launches
    got, walked = composite_tiles(records, starts, counts, 13, 8)
    want, _ = composite_tiles_plain(records, starts, counts, 13, 8)
    torch.cuda.synchronize()
    assert composite_tiles.launches == before + 1
    d = (got - want).abs()
    assert float(d.mean()) < 2e-4
    assert float((d > 1e-3).float().mean()) <= 0.01
    assert bool((walked <= counts).all())


@pytest.mark.cuda
def test_blur_kernel_matches_plain(cuda):
    x = torch.rand(15, 67, 133, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(0))
    before = blur_same.launches
    got = blur_same(x, gaussian_taps())
    want = blur_plain(x, gaussian_taps())
    torch.cuda.synchronize()
    assert blur_same.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_batched_view_equals_single_view(cuda):
    params = random_gaussians(np.random.default_rng(1), n=2048, device=cuda)
    cams = ring_camera_batch(3, 72, 96, device=cuda)
    bg = torch.tensor([0.2, 0.5, 0.8], device=cuda)
    out = batch_render(params, cams, bg, use_trained_exp=True)
    for v in range(3):
        one = render(params, cams.view(v), bg, use_trained_exp=True)
        assert torch.equal(one.render, out.render[v])
        assert torch.equal(one.invdepth, out.invdepth[v])
