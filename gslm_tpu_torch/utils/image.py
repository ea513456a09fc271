"""Image metrics (gslm_tpu/utils/image.py)."""

from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.ndim > 3:
        return torch.mean((a - b) ** 2, dim=tuple(range(1, a.ndim)),
                          keepdim=True)
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.mean((a - b) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(m))


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l1_loss_per_pixel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b)
