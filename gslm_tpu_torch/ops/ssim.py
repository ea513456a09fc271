"""Windowed SSIM (11x11 Gaussian, sigma 1.5) and its per-pixel map
(gslm_tpu/ops/ssim.py). All five windowed statistics ride one
channel-stacked separable blur: kernel B on CUDA tensors, its plain
version on CPU tensors, differentiated by the reversed-tap blur
(``blur_cuda.blur``)."""

from __future__ import annotations

import numpy as np
import torch

from gslm_tpu_torch.ops.blur_cuda import blur

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def gaussian_taps(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 1-D taps of the separable SSIM window, float32."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """Per-pixel SSIM map, same shape as the inputs ((..., C, H, W))."""
    squeeze = img1.ndim == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    stats = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                      dim=1)
    blurred = blur(stats, gaussian_taps(window_size, sigma))
    c = img1.shape[1]
    mu1, mu2, e11, e22, e12 = (blurred[:, i * c:(i + 1) * c] for i in range(5))
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    out = (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) /
           ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    return out[0] if squeeze else out


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Scalar mean SSIM."""
    return torch.mean(ssim_map(img1, img2, window_size))
