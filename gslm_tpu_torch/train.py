"""First-order (Adam) training step (gslm_tpu/train.py).

One iteration: render the camera batch, (1-λ)·L1 + λ·(1-SSIM) plus the
weighted depth L1, gradients of every parameter group and of the mean2d
offset by autograd (kernel C and the reversed-tap blur on the card), the
densification statistics, then Adam with per-group learning rates. The
``training()`` loop, scene I/O and density control come with the trainer
slice.
"""

from __future__ import annotations

import torch

from gslm_tpu_torch.config import OptimizationParams
from gslm_tpu_torch.densify import add_densification_stats
from gslm_tpu_torch.models.cameras import CameraBatch
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                             GaussianParams)
from gslm_tpu_torch.optim import AdamState, adam_step, group_learning_rates
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.solver.residuals import scalar_training_loss
from gslm_tpu_torch.utils.image import psnr


def make_raster_config(n_gaussians: int, *, dup_capacity: int = 1 << 21,
                       live_capacity: int = 0, cull: bool = True,
                       antialiasing: bool = False,
                       impl: str = "auto") -> RasterConfig:
    """Rasterizer capacities for a scene of ``n_gaussians``: the JAX
    heuristic without its TPU-only fields (tile_chunk, pack,
    max_per_tile, mp_route_capacity). With culling, ``live_capacity`` 0
    picks 7/8 of the AABB capacity (the surviving stream measured ~82 %)."""
    dup = min(dup_capacity, max(1 << 14, 16 * n_gaussians))
    live = live_capacity or (dup - (dup >> 3) if cull else 0)
    live = (live // 256) * 256
    return RasterConfig(dup_capacity=dup, antialiasing=antialiasing,
                        impl=impl, cull=cull, live_capacity=live)


def loss_and_grads(params: GaussianParams, cam: CameraBatch,
                   bg: torch.Tensor, depth_weight: float, *,
                   rcfg: RasterConfig, opt: OptimizationParams,
                   active_sh_degree: int, use_exp: bool):
    """The loss of one Adam iteration and its gradients.

    Returns ``(loss, info, depth_l1, grads, g_m2d)``: ``info`` is
    ``scalar_training_loss``'s dict, ``grads`` the gradient of every
    parameter group (zeros for a group the loss does not reach, as
    ``jax.grad`` gives), ``g_m2d`` (P, 2) the mean2d offset's cotangent."""
    m2d = torch.zeros(params.capacity, 2, device=params.xyz.device,
                      requires_grad=True)
    loss, info = scalar_training_loss(
        params, cam, bg, config=rcfg, lambda_dssim=opt.lambda_dssim,
        use_trained_exp=use_exp, active_sh_degree=active_sh_degree,
        alive=params.alive, mean2d_offset=m2d)
    out = info["render"]
    # depth regularization (reference train.py:129-140)
    npix = torch.clamp(torch.sum(cam.depth_mask), min=1.0)
    depth_l1 = torch.sum(torch.abs(out.invdepth - cam.invdepth_gt)
                         * cam.depth_mask) / npix
    loss = loss + depth_weight * depth_l1
    leaves = [getattr(params, g) for g in PARAM_GROUPS] + [m2d]
    found = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d
             for x, d in zip(leaves, found)]
    return (loss.detach(), info, depth_l1.detach(),
            dict(zip(PARAM_GROUPS, grads[:-1])), grads[-1])


def train_step(params: GaussianParams, aux: GaussianAux,
               opt_state: AdamState, cam: CameraBatch, bg: torch.Tensor,
               step: int, spatial_lr_scale: float, depth_weight: float, *,
               rcfg: RasterConfig, opt: OptimizationParams,
               active_sh_degree: int, use_exp: bool, sparse_adam: bool,
               update_stats: bool):
    """One Adam iteration over a (usually B=1) camera batch. Updates
    ``params`` and ``opt_state`` in place; returns ``(params, aux,
    opt_state, metrics)`` with the metrics as 0-d tensors (no host sync)."""
    loss, info, depth_l1, grads, g_m2d = loss_and_grads(
        params, cam, bg, depth_weight, rcfg=rcfg, opt=opt,
        active_sh_degree=active_sh_degree, use_exp=use_exp)
    out = info["render"]
    radii = torch.amax(out.radii, dim=0)             # (P,) over batch views
    if update_stats:
        # stats accumulate the sum of per-view screen gradients: undo the
        # mean-over-views 1/B so magnitudes don't depend on batch size
        aux = add_densification_stats(aux, g_m2d * cam.batch_size, radii)

    lrs = group_learning_rates(opt, step, spatial_lr_scale)
    visible = (radii > 0) if sparse_adam else None
    params, opt_state = adam_step(params, grads, opt_state, lrs, visible)

    render = out.render.detach()
    metrics = {"loss": loss, "l1": torch.mean(info["l1"].detach()),
               "depth_l1": depth_l1,
               "psnr": torch.mean(psnr(render, cam.gt_image)),
               "overflow": torch.amax(out.overflow),
               "max_tile_load": torch.amax(out.max_tile_load)}
    return params, aux, opt_state, metrics
