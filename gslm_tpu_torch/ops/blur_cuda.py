"""Separable zero-padded SAME blur: kernel B (csrc/blur.cu) and its plain
version. Counterpart of ``blur_same`` (gslm_tpu/ops/blur_pallas.py).

The blur is linear, so its VJP is the same blur with the taps reversed
(the JAX package installs that through ``linear_call``) and its JVP is the
same blur of the tangent: ``blur`` is the differentiable entry, a
``torch.autograd.Function`` whose backward and forward-mode rule are
``blur_same`` again, so both launch kernel B on the card and take the plain
version on the CPU; neither differentiates ``blur_plain`` by autograd."""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from gslm_tpu_torch import _build


def _taps(taps) -> tuple[float, ...]:
    return tuple(float(t) for t in np.asarray(taps, np.float32).ravel())


def _shift_add_1d(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """1-D zero-padded SAME correlation along ``dim`` as k shifted adds, the
    terms summed in tap order."""
    k = len(taps)
    r = k // 2
    pad = [0, 0] * (x.ndim - 1 - (dim % x.ndim)) + [r, r]
    xp = F.pad(x, pad)
    n = x.shape[dim]
    out = None
    for t, w in enumerate(taps):
        term = w * xp.narrow(dim, t, n)
        out = term if out is None else out + term
    return out


def blur_plain(x: torch.Tensor, taps) -> torch.Tensor:
    """Plain PyTorch version of kernel B: taps along H, then along W. Shift
    and add, not conv2d, so cuDNN's TF32 never enters."""
    taps = _taps(taps)
    return _shift_add_1d(_shift_add_1d(x, taps, -2), taps, -1)


def blur_same(img: torch.Tensor, taps) -> torch.Tensor:
    """Blur ``img`` (..., H, W) float32 with 1-D ``taps`` along H then W.

    A CUDA tensor goes through kernel B (or the call raises); a CPU tensor
    takes the plain version."""
    taps = _taps(taps)
    if img.device.type == "cpu":
        return blur_plain(img, taps)
    if img.device.type != "cuda" or img.dtype != torch.float32:
        raise TypeError(f"blur_same takes float32 CPU or CUDA tensors, got "
                        f"{img.dtype} on {img.device}")
    k = len(taps)
    if k % 2 == 0 or k > 15:
        raise ValueError(f"blur kernel takes an odd tap count <= 15, got {k}")
    shape = img.shape
    h, w = shape[-2], shape[-1]
    x = img.contiguous().reshape(-1, h, w)
    y = torch.empty_like(x)
    lib = _build.load("blur")
    taps_c = (ctypes.c_float * k)(*taps)
    rc = lib.blur_same(x.data_ptr(), y.data_ptr(), x.shape[0], h, w, taps_c, k,
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "blur_same")
    blur_same.launches += 1
    return y.reshape(shape)


blur_same.launches = 0       # kernel B launches in this process
blur_same.vjp_launches = 0   # of which for ``blur``'s backward
blur_same.jvp_launches = 0   # of which for ``blur``'s forward-mode rule


class Blur(torch.autograd.Function):
    """``blur_same`` with its reversed-tap VJP and same-tap JVP."""

    @staticmethod
    def forward(ctx, img, taps):
        ctx.taps = _taps(taps)
        return blur_same(img, ctx.taps)

    @staticmethod
    def backward(ctx, grad):
        out = blur_same(grad, ctx.taps[::-1])
        if grad.is_cuda:
            blur_same.vjp_launches += 1
        return out, None

    @staticmethod
    def jvp(ctx, tangent, _):
        out = blur_same(tangent, ctx.taps)
        if tangent.is_cuda:
            blur_same.jvp_launches += 1
        return out


def blur(img: torch.Tensor, taps) -> torch.Tensor:
    """Differentiable ``blur_same`` (kernel B forward, backward and in
    forward mode)."""
    return Blur.apply(img, taps)
