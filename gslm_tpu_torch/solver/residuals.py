"""Training losses (gslm_tpu/solver/residuals.py): the first-order scalar
loss of the Adam step, and the per-pixel residual vectors of the LM solver.

Residual weighting (reference training_loss.py:40-43):
    r_l1   = sqrt((1-λ)/n) * sqrt(|I - gt| + 1e-6)
    r_ssim = sqrt(λ/n)     * sqrt(|1 - SSIM| + 1e-6)
with n = 3·H·W per image, so ‖r‖² is the weighted scalar loss. With
``disable_ssim=True`` (what the reference LM trainer runs) the residual is
the plain difference r = I - gt and the ssim slot IS the same tensor, so
‖r‖² doubles, as in the reference. Residuals are multiplied by each view's
pixel-validity mask (padded regions stay zero)."""

from __future__ import annotations

import dataclasses

import torch

from gslm_tpu_torch.models.cameras import CameraBatch
from gslm_tpu_torch.models.gaussians import GaussianParams
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.ops.ssim import ssim_map
from gslm_tpu_torch.renderer import batch_render
from gslm_tpu_torch.struct import Struct
from gslm_tpu_torch.utils.profiling import span


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclasses.dataclass
class ResidualState(Struct):
    """Residual-space vector (the reference's BatchLossImageState)."""

    l1: torch.Tensor     # (B, 3, H, W)
    ssim: torch.Tensor   # (B, 3, H, W)

    @property
    def l1_scalar(self) -> torch.Tensor:
        return _vdot(self.l1, self.l1)

    @property
    def ssim_scalar(self) -> torch.Tensor:
        return _vdot(self.ssim, self.ssim)

    @property
    def loss_scalar(self) -> torch.Tensor:
        return self.l1_scalar + self.ssim_scalar


def res_dot(a: ResidualState, b: ResidualState) -> torch.Tensor:
    return _vdot(a.l1, b.l1) + _vdot(a.ssim, b.ssim)


def res_saxpy(alpha, x: ResidualState, y: ResidualState) -> ResidualState:
    return ResidualState(l1=alpha * x.l1 + y.l1, ssim=alpha * x.ssim + y.ssim)


def res_scale(alpha, x: ResidualState) -> ResidualState:
    return ResidualState(l1=alpha * x.l1, ssim=alpha * x.ssim)


def res_map(fn, r: ResidualState) -> ResidualState:
    """``fn`` of both slots, keeping the ``disable_ssim`` alias (one call
    when ``ssim`` is ``l1``)."""
    l1 = fn(r.l1)
    return ResidualState(l1=l1, ssim=l1 if r.ssim is r.l1 else fn(r.ssim))


def batch_residuals(params, cameras: CameraBatch, bg: torch.Tensor, *,
                    config: RasterConfig = RasterConfig(),
                    lambda_dssim: float = 0.2, disable_ssim: bool = False,
                    use_trained_exp: bool = False,
                    active_sh_degree: int | None = None,
                    alive: torch.Tensor | None = None) -> ResidualState:
    """Render the batch and build the per-pixel residual vector.
    ``params``: ``GaussianParams`` or ``GaussianTensors``."""
    out = batch_render(params, cameras, bg, config=config,
                       active_sh_degree=active_sh_degree,
                       use_trained_exp=use_trained_exp, alive=alive)
    images = out.render * cameras.alpha_mask          # (B, 3, H, W)
    valid = cameras.pixel_valid()                     # (B, 1, H, W)
    gt = cameras.gt_image

    if disable_ssim:
        r = (images - gt) * valid
        return ResidualState(l1=r, ssim=r)

    n = 3.0 * cameras.heights.float() * cameras.widths.float()
    w_l1 = torch.sqrt((1.0 - lambda_dssim) / n)[:, None, None, None]
    w_ssim = torch.sqrt(lambda_dssim / n)[:, None, None, None]
    l1_pp = torch.abs(images - gt)
    ssim_loss_pp = torch.abs(1.0 - ssim_map(images, gt))
    r_l1 = w_l1 * torch.sqrt(l1_pp + 1e-6) * valid
    r_ssim = w_ssim * torch.sqrt(ssim_loss_pp + 1e-6) * valid
    return ResidualState(l1=r_l1, ssim=r_ssim)


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
    with span("gslm.loss"):
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
