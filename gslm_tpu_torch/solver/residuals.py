"""Training losses (gslm_tpu/solver/residuals.py). Only the first-order
scalar loss of the Adam step; the residual state of the LM solver comes
with the LM slice."""

from __future__ import annotations

import torch

from gslm_tpu_torch.models.cameras import CameraBatch
from gslm_tpu_torch.models.gaussians import GaussianParams
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.ops.ssim import ssim_map
from gslm_tpu_torch.renderer import batch_render


def scalar_training_loss(params: GaussianParams, cameras: CameraBatch,
                         bg: torch.Tensor, *,
                         config: RasterConfig = RasterConfig(),
                         lambda_dssim: float = 0.2,
                         use_trained_exp: bool = False,
                         active_sh_degree: int | None = None,
                         alive: torch.Tensor | None = None,
                         mean2d_offset: torch.Tensor | None = None):
    """First-order scalar loss, the mean over views of
    (1-λ)·L1 + λ·(1-SSIM) over each view's valid pixels.

    Returns (loss, dict(l1 (B,), ssim (B,), render RenderOutput))."""
    out = batch_render(params, cameras, bg, config=config,
                       active_sh_degree=active_sh_degree,
                       use_trained_exp=use_trained_exp, alive=alive,
                       mean2d_offset=mean2d_offset)
    images = out.render * cameras.alpha_mask
    valid = cameras.pixel_valid()
    gt = cameras.gt_image
    npix = 3.0 * torch.sum(valid, dim=(1, 2, 3))       # (B,)

    l1 = torch.sum(torch.abs(images - gt) * valid, dim=(1, 2, 3)) / npix
    smap = ssim_map(images, gt) * valid
    ssim_mean = torch.sum(smap, dim=(1, 2, 3)) / npix
    loss_per_view = ((1.0 - lambda_dssim) * l1
                     + lambda_dssim * (1.0 - ssim_mean))
    loss = torch.mean(loss_per_view)
    return loss, {"l1": l1, "ssim": ssim_mean, "render": out}
