"""The least operations and bytes of each stage of a step, from the counts
of ``work.view_work`` and fixed per-item costs taken from the algorithm's
equations; and the chip's published peaks. None of these numbers is read
from the program or from its kernels' code, so a redesigned kernel cannot
move its own yardstick: a share of these bounds stays at or under 100 %
whatever implements the stage.

Each cost is a floor: an implementation may do more (the exact cull, a
recomputed forward, a log-space transmittance) but not less.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks at its 700 W limit
FP32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES = 3.35e12         # HBM3 bytes/s

# Compositing, per (record, pixel) pair that contributes (alpha >= 1/255
# before the pixel's exit), from ops/composite.py's equations:
# forward: dx, dy 2; the conic's quadratic form, pre-scaled, 7; exp 1;
# alpha = opacity·exp 1; transmittance T·(1 - alpha) 2; weight alpha·T 1;
# four weighted sums (r, g, b, invdepth) as fused multiply-adds 8.
FWD_OPS_PER_PAIR = 22
# backward: the forward's alpha again 11; T before the record from the
# running product 2; weight 1; the four colour cotangents 4; dL/dalpha
# from the colours still behind (4 differences, 4 fused multiply-adds) 12;
# dL/dpower 1, dL/dopacity 1; dL/dmean2d 6; dL/dconic 4; nothing for the
# ten per-record sums, which the bytes count.
BWD_OPS_PER_PAIR = 42
# bytes: each splat with a contributing pair read once (10 float32
# fields), its cotangent written once; each pixel written or read once
RECORD_BYTES = 40
PIXEL_OUT_BYTES = 20        # r, g, b, invdepth, final transmittance
PIXEL_COT_BYTES = 20        # their cotangents

# Per Gaussian, projection, EWA covariance, tile rect and degree-3 SH
# colour (ops/projection.py): ~300 operations; it reads the 59 floats of
# its parameters and writes 16 words of splat; the backward reads the
# splat cotangents and the parameters again and writes 59 gradients.
PRE_OPS, PRE_BWD_OPS = 300, 600
PRE_BYTES, PRE_BWD_BYTES = (59 + 16) * 4, (10 + 59 + 59) * 4
# Per live tile record: its 8-byte (tile, depth) key sorted once, read and
# written (16 B); the AABB records, the gather and the backward's scatter
# are the program's choices and count nothing.
SORT_BYTES = 16
# Per pixel and channel, SSIM and L1: five statistics through the 11-tap
# separable blur (5 × 2 passes × 11 taps × 2) and the formula, ~240
# operations forward and twice that backward; render and target read.
SSIM_OPS, SSIM_BWD_OPS, SSIM_BYTES = 240, 480, 8
# Per parameter, Adam: 14 operations; p, g, m, v read and p, m, v written.
ADAM_OPS, ADAM_BYTES = 14, 28
# Per pixel and channel, the served frame: clamp, ×255 on the device,
# read once and written once.
FRAME_OPS, FRAME_BYTES = 2, 8


def least_s(ops: float, nbytes: float) -> float:
    """The least time of a stage: the larger of its operations at the fp32
    peak and its bytes at the HBM peak."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)


def composite_fwd_s(w: dict) -> float:
    return least_s(w["pairs"] * FWD_OPS_PER_PAIR,
                   w["splats"] * RECORD_BYTES + w["pixels"] * PIXEL_OUT_BYTES)


def composite_bwd_s(w: dict) -> float:
    return least_s(w["pairs"] * BWD_OPS_PER_PAIR,
                   w["splats"] * 2 * RECORD_BYTES
                   + w["pixels"] * PIXEL_COT_BYTES)


def front_s(w: dict, backward: bool) -> float:
    """Preprocess and SH (and its backward, with ``backward``), and the
    sort of the live records."""
    g = w["gaussians"]
    t = (least_s(g * PRE_OPS, g * PRE_BYTES)
         + least_s(0, w["records"] * SORT_BYTES))
    if backward:
        t += least_s(g * PRE_BWD_OPS, g * PRE_BWD_BYTES)
    return t


def loss_s(w: dict) -> float:
    n = 3 * w["pixels"]
    return least_s(n * (SSIM_OPS + SSIM_BWD_OPS), n * 2 * SSIM_BYTES)


def adam_s(n_params: int) -> float:
    return least_s(n_params * ADAM_OPS, n_params * ADAM_BYTES)


def frame_s(w: dict) -> float:
    n = 3 * w["pixels"]
    return least_s(n * FRAME_OPS, n * FRAME_BYTES)
