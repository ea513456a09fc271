"""The port's copies of the two OpenCV resampling calls of the JAX depth
path, in numpy (the card's machine has no OpenCV).

- ``resize_linear(img, (w, h))`` = ``cv2.resize(img, (w, h))``
  (``INTER_LINEAR``) on float32: half-pixel centres, source coordinates
  clamped at the borders, a horizontal then a vertical pass in float32.
  ``models/scene.load_camera_pixels`` resizes depth maps with it.
- ``remap_linear_replicate(img, mapx, mapy)`` = ``cv2.remap(img, mapx,
  mapy, INTER_LINEAR, borderMode=BORDER_REPLICATE)``: the bilinear sample
  at each (x, y), indices clamped to the image, in OpenCV 5.x's float32
  arithmetic. OpenCV 4.x rounds float coordinates to 1/32 pixel first
  (``INTER_BITS = 5``); the OpenCV the JAX package is tested against
  (5.x) samples exactly, and so does this copy.
  ``tools/make_depth_scale`` samples the mono depth with it.
"""

from __future__ import annotations

import numpy as np


def _linear_taps(in_size: int, out_size: int):
    """OpenCV's ``INTER_LINEAR`` coefficients along one axis: (source
    index (out,), the next one clamped, its float32 weight): the source
    coordinate (dx + 0.5)·in/out − 0.5, its weight zero where it falls
    before the first sample or on or past the last."""
    scale = 1.0 / (out_size / in_size)    # OpenCV's 1 / inv_scale
    f = (np.arange(out_size) + 0.5) * scale - 0.5   # in float64, then
    s = np.floor(f)                                 # the fraction rounded
    f = (f - s).astype(np.float32)                  # to float32
    s = s.astype(np.int64)
    low, high = s < 0, s >= in_size - 1
    f = np.where(low | high, np.float32(0), f).astype(np.float32)
    s = np.clip(s, 0, in_size - 1)
    return s, np.minimum(s + 1, in_size - 1), f


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` with ``INTER_LINEAR`` for float32 (H, W)
    or (H, W, C); ``size`` is (width, height)."""
    w, h = size
    img = np.asarray(img, np.float32)
    if img.shape[:2] == (h, w):
        return img.copy()
    x0, x1, fx = _linear_taps(img.shape[1], w)
    y0, y1, fy = _linear_taps(img.shape[0], h)
    tail = (1,) * (img.ndim - 2)
    one = np.float32(1)
    ax = fx.reshape((1, -1) + tail)
    rows = img[:, x0] * (one - ax) + img[:, x1] * ax
    ay = fy.reshape((-1, 1) + tail)
    return (rows[y0] * (one - ay) + rows[y1] * ay).astype(np.float32)


def _fma(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """x·y + z of float32 arrays rounded once to float32, as a fused
    multiply-add: the product is exact in float64, the sum rounds there
    first (double rounding differs from one rounding only when the float64
    sum lies within 2^-29 ulp of a float32 midpoint)."""
    return (x.astype(np.float64) * y + z).astype(np.float32)


def remap_linear_replicate(img: np.ndarray, mapx: np.ndarray,
                           mapy: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, mapx, mapy, INTER_LINEAR, BORDER_REPLICATE)`` for a
    float32 (H, W) image: the bilinear sample at every (mapx, mapy), in
    pixel units with integer coordinates at pixel centres, its four
    neighbours' indices clamped to the image. OpenCV 5.x's arithmetic, bit
    for bit: in float32, the fractions x − ⌊x⌋ and y − ⌊y⌋, then two
    horizontal and one vertical lerp, each a fused multiply-add. Returns
    float32 of ``mapx``'s shape."""
    img = np.asarray(img, np.float32)
    x = np.asarray(mapx, np.float32)
    y = np.asarray(mapy, np.float32)
    xf, yf = np.floor(x), np.floor(y)
    fx, fy = x - xf, y - yf
    h, w = img.shape
    x0 = np.clip(xf, 0, w - 1).astype(np.int64)
    x1 = np.clip(xf + 1, 0, w - 1).astype(np.int64)
    y0 = np.clip(yf, 0, h - 1).astype(np.int64)
    y1 = np.clip(yf + 1, 0, h - 1).astype(np.int64)
    a, b = img[y0, x0], img[y0, x1]
    c, d = img[y1, x0], img[y1, x1]
    top = _fma(fx, b - a, a)
    bottom = _fma(fx, d - c, c)
    return _fma(fy, bottom - top, top)
