"""General numeric helpers (the part of gslm_tpu/utils/general.py the
render, Adam and density-control paths need): the opacity activation's
inverse, quaternion algebra and the learning-rate schedules."""

from __future__ import annotations

import math

import numpy as np
import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) normalized (w,x,y,z) quaternion → (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000
             ) -> torch.Tensor:
    """Log-linear learning-rate decay with an optional sine-ramped delay,
    in float32 as the JAX version computes it. Returns a 0-d float32 CPU
    tensor."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    step = f32(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t)
                         + torch.log(f32(lr_final)) * t)
    lr = delay_rate * log_lerp
    return torch.where(step < 0, 0.0, lr)


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1000000):
    """Host-side schedule closure in double precision, for loops that pick a
    learning rate per step."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * float(np.clip(step / lr_delay_steps, 0, 1)))
        else:
            delay_rate = 1.0
        t = float(np.clip(step / max_steps, 0, 1))
        log_lerp = math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper
