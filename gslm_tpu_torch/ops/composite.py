"""Closed-form front-to-back alpha compositing (gslm_tpu/ops/composite.py).

With splats sorted front to back and alphas gated at 1/255, the running
transmittance is one log-space cumsum. A splat contributes a_i·T_i iff
T_i(1-a_i) >= 1e-4; the background uses the transmittance frozen at the
first failure. The CUDA compositor (csrc/composite_fwd.cu) walks the same
rule record by record; this closed form is its plain version."""

from __future__ import annotations

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def clip_alpha(alpha_raw: torch.Tensor) -> torch.Tensor:
    """min(alpha, 0.99) with a straight-through gradient (the clip is
    forward-only, as in the CUDA backward)."""
    clipped = torch.clamp(alpha_raw, max=ALPHA_MAX)
    return alpha_raw + (clipped - alpha_raw).detach()


def composite_weights(alpha: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """alpha (N, ...) sorted front to back along dim 0 → (weights (N, ...),
    t_final (...))."""
    contrib = alpha >= ALPHA_MIN
    a = torch.where(contrib, alpha, 0.0)
    log_step = torch.log1p(-a)
    log_t_after = torch.cumsum(log_step, dim=0)
    t_after = torch.exp(log_t_after)
    t_before = torch.exp(log_t_after - log_step)
    ok = contrib & (t_after >= T_EPS)
    weights = torch.where(ok, a * t_before, 0.0)

    fail = contrib & (t_after < T_EPS)
    any_fail = torch.any(fail, dim=0)
    t_frozen = torch.amax(torch.where(fail, t_before, 0.0), dim=0)
    t_final = torch.where(any_fail, t_frozen, t_after[-1])
    return weights, t_final


def alpha_from_conic(mean2d, conic, opacity, px, py, gate):
    """Splat alphas at pixel positions: mean2d (N,2), conic (N,3), opacity
    (N,) against pixel grids px/py (...); ``gate`` (N, ...) marks pairs
    allowed to contribute. Returns (N, ...)."""
    shape = (mean2d.shape[0],) + (1,) * px.ndim
    dx = mean2d[:, 0].reshape(shape) - px[None]
    dy = mean2d[:, 1].reshape(shape) - py[None]
    c0 = conic[:, 0].reshape(shape)
    c1 = conic[:, 1].reshape(shape)
    c2 = conic[:, 2].reshape(shape)
    power = -0.5 * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy
    gate = gate & (power <= 0.0)
    power = torch.where(gate, power, -100.0)
    alpha_raw = opacity.reshape(shape) * torch.exp(power)
    return clip_alpha(alpha_raw)
