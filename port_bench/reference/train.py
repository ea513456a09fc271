"""Plain PyTorch reference of the Adam iteration: (1-λ)·L1 + λ·(1-SSIM)
of one view, gradients by autograd through ``reference.render``, and the
per-group Adam update with the 3DGS learning rates.

A frozen copy of the port's plain versions (``ops/ssim.py`` with the
shift-and-add blur of ``ops/blur_cuda.blur_plain``,
``solver/residuals.scalar_training_loss``, ``optim.adam_step``,
``utils/general.expon_lr``), imports rewritten; it imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.render import FP32, Precision, render

GROUPS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "exposure")
BETA1, BETA2 = 0.9, 0.999
EPS = {g: 1e-15 for g in GROUPS} | {"exposure": 1e-8}
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2


def gaussian_taps(window_size: int = 11, sigma: float = 1.5):
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return tuple(float(t) for t in (g / g.sum()).astype(np.float32))


def _shift_add_1d(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    r = len(taps) // 2
    pad = [0, 0] * (x.ndim - 1 - (dim % x.ndim)) + [r, r]
    xp = F.pad(x, pad)
    n = x.shape[dim]
    out = None
    for t, w in enumerate(taps):
        term = w * xp.narrow(dim, t, n)
        out = term if out is None else out + term
    return out


def blur(x: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded SAME separable blur, taps along H then W."""
    return _shift_add_1d(_shift_add_1d(x, taps, -2), taps, -1)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM of (C, H, W) images (11x11 Gaussian, sigma 1.5)."""
    stats = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    b = blur(stats, gaussian_taps())
    c = img1.shape[0]
    mu1, mu2, e11, e22, e12 = (b[i * c:(i + 1) * c] for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    return (((2 * mu1_mu2 + SSIM_C1) * (2 * (e12 - mu1_mu2) + SSIM_C2))
            / ((mu1_sq + mu2_sq + SSIM_C1)
               * (e11 - mu1_sq + e22 - mu2_sq + SSIM_C2)))


def loss_of(image: torch.Tensor, gt: torch.Tensor, lambda_dssim: float,
            q: Precision = FP32) -> torch.Tensor:
    """(1-λ)·mean |I - gt| + λ·(1 - mean SSIM) of one view."""
    n = float(image.numel())
    l1 = q(torch.sum(torch.abs(image - gt)) / n)
    ssim = q(torch.sum(q(ssim_map(image, gt))) / n)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000):
    """Log-linear decay with an optional sine-ramped delay, in float32."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    step = f32(step)
    delay = (lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
        0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
        if lr_delay_steps > 0 else 1.0)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t)
                     + torch.log(f32(lr_final)) * t)
    return torch.where(step < 0, 0.0, delay * lerp)


def group_lrs(opt: dict, step: int, spatial_lr_scale: float) -> dict:
    """3DGS's per-group learning rates at ``step`` (``opt``: the mix's
    optimisation settings)."""
    return {
        "xyz": expon_lr(step, opt["position_lr_init"] * spatial_lr_scale,
                        opt["position_lr_final"] * spatial_lr_scale,
                        lr_delay_mult=opt["position_lr_delay_mult"],
                        max_steps=opt["position_lr_max_steps"]),
        "features_dc": opt["feature_lr"],
        "features_rest": opt["feature_lr"] / 20.0,
        "opacity": opt["opacity_lr"],
        "scaling": opt["scaling_lr"],
        "rotation": opt["rotation_lr"],
        "exposure": expon_lr(step, opt["exposure_lr_init"],
                             opt["exposure_lr_final"],
                             lr_delay_steps=opt["exposure_lr_delay_steps"],
                             lr_delay_mult=opt["exposure_lr_delay_mult"],
                             max_steps=opt["iterations"]),
    }


@torch.no_grad()
def adam_step(p: dict, grads: dict, mu: dict, nu: dict, t: int, lrs: dict,
              q: Precision = FP32) -> None:
    """One Adam update of every group, in place; ``t`` the 1-based step."""
    bc1 = 1.0 - torch.tensor(BETA1) ** t
    bc2 = 1.0 - torch.tensor(BETA2) ** t
    for g in GROUPS:
        mu[g].copy_(q(BETA1 * mu[g] + (1 - BETA1) * grads[g]))
        nu[g].copy_(q(BETA2 * nu[g] + (1 - BETA2) * grads[g] * grads[g]))
        upd = lrs[g] * (mu[g] / bc1) / (torch.sqrt(nu[g] / bc2) + EPS[g])
        p[g].copy_(q(p[g] - upd))


def follow(g0: dict, cams: list, targets: list, bg: torch.Tensor, opt: dict,
           first_step: int, adam_t0: int, spatial_lr_scale: float,
           q: Precision = FP32) -> dict:
    """Follow len(cams) Adam iterations of one view each from the groups
    ``g0`` (copied), with zero moments at Adam step ``adam_t0``. Returns
    dict(losses [float], grad_norms {group: norm of step 1's gradient},
    params {group: tensor after the last step})."""
    p = {k: q(v.detach().clone()) for k, v in g0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad_norms = [], {}
    for i, (cam, gt) in enumerate(zip(cams, targets)):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        image, _ = render(leaves, cam, bg, q)
        loss = loss_of(image, gt, opt["lambda_dssim"], q)
        found = torch.autograd.grad(loss, [leaves[k] for k in GROUPS],
                                    allow_unused=True)
        grads = {k: q(torch.zeros_like(p[k]) if d is None else d)
                 for k, d in zip(GROUPS, found)}
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(v))
                          for k, v in grads.items()}
        losses.append(float(loss.detach()))
        del leaves, image, loss, found
        adam_step(p, grads, mu, nu, adam_t0 + i + 1,
                  group_lrs(opt, first_step + i, spatial_lr_scale), q)
        del grads
    return {"losses": losses, "grad_norms": grad_norms, "params": p}
