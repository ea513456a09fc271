"""General helpers (gslm_tpu/utils/general.py): the opacity activation's
inverse, quaternion algebra, the covariance from scaling and rotation,
the learning-rate schedules and
``safe_state``, the trainer's stdout and host-seed set-up."""

from __future__ import annotations

import math

import numpy as np
import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


class _TimestampedStdout:
    """``safe_state``'s stdout: writes to ``inner``, each line that ends in
    a newline with a `` [dd/mm hh:mm:ss]`` suffix, or nothing if
    ``silent``."""

    def __init__(self, inner, silent: bool):
        self.inner, self.silent = inner, silent

    def write(self, x):
        if self.silent:
            return
        if x.endswith("\n"):
            from datetime import datetime
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            x = x[:-1] + f" [{stamp}]\n"
        self.inner.write(x)

    def flush(self):
        self.inner.flush()

    def isatty(self):
        return self.inner.isatty()


def safe_state(silent: bool = False, seed: int = 0):
    """Timestamp or silence stdout and seed the host RNGs (reference
    utils/general_utils.py:123-144): every line that ends in a newline gets
    a `` [dd/mm hh:mm:ss]`` suffix, ``silent`` drops all output, and
    ``random`` and ``np.random`` are seeded with ``seed``. The wrapper stays
    on ``sys.stdout`` until the caller puts its own stream back; a repeated
    call wraps the stream under the wrapper instead of stacking. The
    trainer's own draws come from explicit generators, so torch's global
    seed is left alone."""
    import random as _random
    import sys

    inner = sys.stdout
    if isinstance(inner, _TimestampedStdout):
        inner = inner.inner
    sys.stdout = _TimestampedStdout(inner, silent)
    _random.seed(seed)
    np.random.seed(seed)


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


def build_scaling_rotation(scale: torch.Tensor,
                           q: torch.Tensor) -> torch.Tensor:
    """L = R(q) diag(scale): (..., 3) x (..., 4) → (..., 3, 3); the
    covariance is Σ = L Lᵀ (reference general_utils.py:102-111)."""
    return quat_to_rotmat(quat_normalize(q)) * scale[..., None, :]


def covariance_from_scaling_rotation(scale: torch.Tensor,
                                     q: torch.Tensor) -> torch.Tensor:
    """(..., 6) upper triangle (xx, xy, xz, yy, yz, zz) of Σ = L Lᵀ
    (reference gaussian_model.py:36-41 and strip_symmetric)."""
    L = build_scaling_rotation(scale, q)
    cov = L @ L.transpose(-1, -2)
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                       dim=-1)


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
