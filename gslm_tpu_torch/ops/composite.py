"""Closed-form front-to-back alpha compositing (gslm_tpu/ops/composite.py).

With splats sorted front to back and alphas gated at 1/255, the running
transmittance is one log-space cumsum. A splat contributes a_i·T_i iff
T_i(1-a_i) >= 1e-4; the background uses the transmittance frozen at the
first failure. The CUDA compositors (csrc/composite_fwd.cu and its
backward, csrc/composite_bwd.cu) walk the same rule record by record; this
closed form, and PyTorch's autograd of it, are their plain versions."""

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


def exit_state(alpha: torch.Tensor, count: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-pixel state the forward compositor saves for its backward,
    in closed form: alpha (N, ...) front to back, count (...) records in
    each segment → (log-transmittance sum at the exit, exit position), the
    exit being the first contributing record with T_after < 1e-4 (the sum
    stops before it) or ``count`` when none fails. Not differentiable."""
    alpha = alpha.detach()
    contrib = alpha >= ALPHA_MIN
    log_t_after = torch.cumsum(torch.log1p(-torch.where(contrib, alpha, 0.0)),
                               dim=0)
    fail = contrib & (torch.exp(log_t_after) < T_EPS)
    any_fail = torch.any(fail, dim=0)
    first = torch.argmax(fail.to(torch.uint8), dim=0)   # first True
    before = torch.gather(log_t_after, 0,
                          torch.clamp(first - 1, min=0)[None])[0]
    lsum = torch.where(any_fail, torch.where(first > 0, before, 0.0),
                       log_t_after[-1])
    pos = torch.where(any_fail, first, count)
    return lsum, pos.to(alpha.dtype)


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
