"""The port's image codec: 8- and 16-bit PNG read and write, and Pillow's
resize, in numpy and ``zlib``.

The JAX package reads every image through Pillow and depth maps through
OpenCV, which the card's machine lacks. So PNG takes this codec on every
machine, and the same file gives the same pixels everywhere. Another
format (JPEG) goes through Pillow where it is installed (``load_image``)
and raises where it is not.

- ``read_png``: 8- and 16-bit, non-interlaced PNG of colour types 0
  (grey), 2 (RGB), 4 (grey + alpha) and 6 (RGBA), all five row filters.
- ``read_png_cv2``: ``read_png`` in the layout of OpenCV's
  ``cv2.imread(path, IMREAD_UNCHANGED)`` (BGR(A), grey + alpha as BGRA),
  which the JAX depth path indexes.
- ``write_png``: 8- or 16-bit, filter Up on every row, zlib level 1.
- ``resize_uint8``: Pillow's ``Image.resize(size, filter)`` for BICUBIC
  (the default) and LANCZOS (widened support on downscale, 22-bit
  fixed-point coefficients, a horizontal then a vertical pass with a uint8
  clip between them, RGBA premultiplied by alpha around it), bit for bit.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type → samples per pixel
_COLOUR_TYPES = {c: t for t, c in _CHANNELS.items()}
_FILTER_NONE, _FILTER_SUB, _FILTER_UP, _FILTER_AVERAGE, _FILTER_PAETH = range(5)


def is_png(path: str) -> bool:
    """Whether the file starts with PNG's signature."""
    with open(path, "rb") as f:
        return f.read(len(_SIGNATURE)) == _SIGNATURE


def _chunks(data: bytes, path: str):
    """(type, payload) of every chunk, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo filters None, Sub and Up, one row at a time, each vectorised."""
    height, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, filt = int(rows[y, 0]), rows[y, 1:]
        if ftype == _FILTER_NONE:
            row = filt
        elif ftype == _FILTER_SUB:
            # recon[x] = filt[x] + recon[x - bpp]: a running sum per channel
            row = np.cumsum(filt.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        else:
            row = filt + prior
        out[y] = row
        prior = out[y]
    return out


def _unfilter_diagonals(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of the five filters, one anti-diagonal of pixels at a
    time: pixel (y, x) needs only its left (a), upper (b) and upper-left (c)
    neighbours, which lie on the two diagonals before its own, so every
    pixel of a diagonal, all channels at once, is one numpy step. The image
    is held skewed, ``skew[y + x, y + 1] = pixel (y, x)``, so that a
    diagonal and its neighbours are contiguous slices; entries off the
    image stay zero, as the filters take them."""
    height, w = rows.shape[0], (rows.shape[1] - 1) // bpp
    # per row, 1 where its filter predicts from a, b, (a + b) / 2, Paeth
    uses = [(rows[:, :1] == t).astype(np.int16) for t in range(1, 5)]
    yy, xx = np.mgrid[0:height, 0:w]
    filt = np.zeros((height + w - 1, height + 1, bpp), np.int16)
    filt[yy + xx, yy + 1] = rows[:, 1:].reshape(height, w, bpp)
    skew = np.zeros_like(filt)
    zero = np.zeros((1, bpp), np.int16)
    for k in range(height + w - 1):
        lo, hi = max(0, k - w + 1), min(height - 1, k) + 1
        a = skew[k - 1, lo + 1:hi + 1] if k else zero
        b = skew[k - 1, lo:hi] if k else zero
        c = skew[k - 2, lo:hi] if k > 1 else zero
        pa, pb = np.abs(b - c), np.abs(a - c)    # |p - a|, |p - b|
        pc = np.abs(a + b - 2 * c)                # p = a + b - c
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        sub, up, avg, pth = (u[lo:hi] for u in uses)
        pred = sub * a + up * b + avg * ((a + b) >> 1) + pth * paeth
        skew[k, lo + 1:hi + 1] = (filt[k, lo + 1:hi + 1] + pred) & 0xFF
    return skew[yy + xx, yy + 1].astype(np.uint8).reshape(height, w * bpp)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    types = rows[:, 0]
    if types.max(initial=0) > _FILTER_PAETH:
        y = int(np.argmax(types > _FILTER_PAETH))
        raise ValueError(f"{path}: row {y} has PNG filter type {types[y]}")
    if types.max(initial=0) <= _FILTER_UP:
        return _unfilter_rows(rows, bpp)
    # Average and Paeth chain every byte to the one before it in its row
    return _unfilter_diagonals(rows, bpp)


def read_png(path: str) -> np.ndarray:
    """An 8- or 16-bit PNG → uint8 or uint16 (H, W, C), C = 1, 2, 3 or 4
    (grey, grey + alpha, RGB, RGBA). A palette, interlaced or 1-, 2- or
    4-bit file raises ``NotImplementedError``."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise NotImplementedError(
            f"{path}: PNG colour type {ctype} (palette) is not supported; "
            f"only 8-bit grey, grey + alpha, RGB and RGBA are")
    if depth not in (8, 16):
        raise NotImplementedError(
            f"{path}: PNG of {depth}-bit samples is not supported; only "
            f"8- and 16-bit samples are")
    if interlace:
        raise NotImplementedError(
            f"{path}: interlaced (Adam7) PNG is not supported")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8             # bytes per pixel, the filters' unit
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{width}x{height}x{c} at {depth} bits")
    img = _unfilter(raw, height, width * bpp, bpp, path)
    if depth == 16:                  # big-endian samples
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(height, width, c)


def read_png_cv2(path: str) -> np.ndarray:
    """``read_png`` laid out as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
    returns it: grey (H, W); grey + alpha as BGRA (grey three times, then
    alpha); RGB as BGR; RGBA as BGRA."""
    img = read_png(path)
    c = img.shape[2]
    if c == 1:
        return img[..., 0]
    if c == 2:
        return img[..., [0, 0, 0, 1]]
    return img[..., [2, 1, 0, 3][:c]]


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 or uint16 (H, W) or (H, W, C), C = 1-4, as an 8- or
    16-bit PNG: filter Up on every row, zlib level 1."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16 pixels, got "
                        f"{img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOUR_TYPES:
        raise ValueError(f"write_png: {c} channels (1-4 are written)")
    depth = 8 * img.dtype.itemsize
    # 16-bit samples are big-endian; the filter works on their bytes
    rows = np.ascontiguousarray(img, img.dtype.newbyteorder(">")
                                if depth == 16 else None)
    rows = rows.view(np.uint8).reshape(h, w * c * depth // 8)
    up = np.empty((h, rows.shape[1] + 1), np.uint8)
    up[:, 0] = _FILTER_UP
    up[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=up[1:, 1:])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(up.tobytes(), 1))
                + _chunk(b"IEND", b""))


# ---- Pillow's resize (libImaging/Resample.c) -------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5), in its operation order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    """Pillow's ``sinc_filter``: sin(πx) / (πx), 1 at 0."""
    px = x * math.pi
    return np.where(x == 0.0, 1.0, np.sin(px) / np.where(x == 0.0, 1.0, px))


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's ``lanczos_filter``: the sinc truncated by sinc(x / 3) on
    [-3, 3)."""
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


# filter name → (Pillow's filter function, its support)
_FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def _coefficients(in_size: int, out_size: int, filt: str = "bicubic"):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for
    the filter ``filt`` over the whole input: (xmin (out,), taps (out,
    ksize) int32 in 22-bit fixed point, zero past each output's xmax)."""
    fn, filter_support = _FILTERS[filt]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    inside = x[None, :] < xmax[:, None]
    w = np.where(inside, fn(
        (x[None, :] + xmin[:, None] - center[:, None] + 0.5)
        * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):        # the sum in Pillow's order, tap by tap
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * (1 << _PRECISION_BITS)
    taps = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int32)
    return xmin, np.where(inside, taps, 0)


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   filt: str) -> np.ndarray:
    """One pass along ``axis`` (0: rows, 1: columns) of uint8 (H, W, C), in
    int32 as Pillow's C sums (255 times the taps' absolute sum stays below
    2^31)."""
    in_size = img.shape[axis]
    xmin, taps = _coefficients(in_size, out_size, filt)
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    tail = (1,) * (src.ndim - 1)
    for k in range(taps.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        acc += src[idx] * taps[:, k].reshape((-1,) + tail)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_uint8(img: np.ndarray, size: tuple[int, int],
                 filt: str = "bicubic") -> np.ndarray:
    """Pillow's ``Image.fromarray(img).resize(size, filter)`` for uint8
    (H, W, C), C = 1-4: ``size`` is (width, height), ``filt`` "bicubic"
    (Pillow's default) or "lanczos" (``Image.LANCZOS``). Grey + alpha and
    RGBA are premultiplied by alpha around the passes, as Pillow's La and
    RGBa modes do. The same size returns a copy."""
    if filt not in _FILTERS:
        raise ValueError(f"resize_uint8: filter {filt!r}, expected one of "
                         f"{sorted(_FILTERS)}")
    w, h = size
    img = np.asarray(img, np.uint8)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    if (h, w) == img.shape[:2]:
        return img[..., 0].copy() if squeeze else img.copy()
    alpha = img.shape[2] in (2, 4)
    if alpha:
        img = _premultiply(img)
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1, filt)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0, filt)
    if alpha:
        out = _unpremultiply(out)
    return out[..., 0] if squeeze else out


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA → RGBa (Pillow's ``rgbA2rgba``): colour · alpha / 255, rounded
    as MULDIV255."""
    a = img[..., -1:].astype(np.uint32)
    t = img[..., :-1].astype(np.uint32) * a + 128
    colour = ((t >> 8) + t) >> 8
    return np.concatenate([colour.astype(np.uint8), img[..., -1:]], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa → RGBA (Pillow's ``rgba2rgbA``): colour · 255 / alpha,
    truncated and clipped, untouched where alpha is 0 or 255."""
    a = img[..., -1:].astype(np.int64)
    colour = img[..., :-1].astype(np.int64)
    div = np.clip(255 * colour // np.maximum(a, 1), 0, 255)
    colour = np.where((a == 0) | (a == 255), colour, div)
    return np.concatenate([colour.astype(np.uint8), img[..., -1:]], axis=-1)


def load_image(path: str) -> np.ndarray:
    """Any 8-bit image file → uint8 (H, W) or (H, W, C), as ``np.asarray``
    of Pillow's image gives it. PNG takes ``read_png`` (grey comes back
    (H, W), as Pillow gives it; a 16-bit PNG raises
    ``NotImplementedError``: only depth maps are 16-bit, and they are read
    with ``read_png_cv2``); another format (JPEG) needs Pillow and raises
    ``ImportError`` without it."""
    if is_png(path):
        img = read_png(path)
        if img.dtype != np.uint8:
            raise NotImplementedError(
                f"{path}: a 16-bit image is read as a depth map only; "
                f"images must be 8-bit")
        return img[..., 0] if img.shape[2] == 1 else img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: a {os.path.splitext(path)[1] or 'non-PNG'} image needs "
            f"Pillow, which is not installed; the port reads only PNG "
            f"without it") from e
    with Image.open(path) as im:
        return np.asarray(im)
