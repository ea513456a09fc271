"""Kernel A's patch design (csrc/composite_fwd.cu) on the CPU.

Kernel A runs only on the card. Here its algorithm is mirrored in float32
numpy: the 8x4 warp patches (``PATCH_PIXELS``), the per-record patch mask
(``patch_masks``), warps skipping the records whose bit is clear without
evaluating them, and the block's exit at the first chunk boundary where
every pixel is done. Cases: a random scene, a dense one (segments of more
than 256 records, pixels that exit), buckets of 2 and 4 with rects, and a
72-row view (partial tiles, as 1080 rows are 67.5 tiles).

- With the mask and without it the mirror is bitwise equal: rows 0-6 and
  ``walked``. That is the claim that makes the redesign safe: a pair whose
  bit is clear could not have contributed.
- The mirror equals ``composite_tiles_plain`` at the knife-edge bound of
  the parity tests (mean |Δ| < 2e-4, at most 1 % above 1e-3; exit positions
  at most 1 % apart) and JAX's Pallas forward in interpret mode at
  tests/test_pallas.py's bound.
- ``patch_masks`` is conservative on adversarial records
  (tests/patch_cases.py): no bit is clear where the plain float32 pair
  arithmetic, stepwise or with the power rounded once, gives a >= 1/255 at
  a pixel of the patch; conics that are not positive definite and
  non-finite opacities get every bit.

    python -m pytest tests/test_torch_fwd_patch.py -q
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.ops.projection import preprocess as j_preprocess
from gslm_tpu.ops.rasterize_pallas import rasterize_pallas as j_rasterize_pallas
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu_torch.ops.projection import Splats2D
from gslm_tpu_torch.ops.rasterize_cuda import (PATCH_PIXELS, PIX,
                                               composite_tiles_plain,
                                               patch_masks, rect_gate,
                                               tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
# pytest puts tests/ on sys.path; an installed ``tests`` package can shadow
# the name ``tests.patch_cases``
from patch_cases import KINDS, adversarial_records, pair_contributes

CAP = 1 << 14
BG = np.array([0.2, 0.5, 0.8], np.float32)
# lanes of the warps whose bits a mask sets, for each of the 256 masks
_LANES = [np.concatenate([np.arange(32 * w, 32 * w + 32) for w in range(8)
                          if m >> w & 1] or [np.zeros(0, int)])
          for m in range(256)]
# the patch of each row-major tile pixel
_PATCH_OF = np.empty(PIX, int)
_PATCH_OF[PATCH_PIXELS] = np.arange(PIX) // 32


def _kernel_a(rec, starts, counts, ntx, view_rows, rects=None, masked=True):
    """Kernel A in float32 numpy: (tiles (ntiles, 7, 256), walked). Thread
    k is pixel PATCH_PIXELS[k]; for each record only the warps whose mask
    bit is set evaluate it (``masked=False``: every warp, but for the rect
    gate)."""
    f32 = np.float32
    ntiles = len(counts)
    out = np.zeros((ntiles, 7, PIX), f32)
    walked = np.zeros(ntiles, np.int32)
    for t in range(ntiles):
        txc, tyc = (t % ntx) * 16, ((t // ntx) % view_rows) * 16
        px = (txc + PATCH_PIXELS % 16).astype(f32)
        py = (tyc + PATCH_PIXELS // 16).astype(f32)
        s, cnt = int(starts[t]), int(counts[t])
        seg = rec[s:s + cnt]
        rseg = None if rects is None else torch.from_numpy(rects[s:s + cnt])
        if masked:
            masks = patch_masks(torch.from_numpy(seg)[None], torch.tensor([t]),
                                ntx, view_rows,
                                None if rseg is None else rseg[None])[0]
        else:
            masks = torch.full((cnt,), 0xFF, dtype=torch.int32)
            if rseg is not None:
                masks[~rect_gate(rseg[None], torch.tensor([t]), ntx,
                                 view_rows)[0]] = 0
        masks = masks.numpy()
        lsum, T = np.zeros(PIX, f32), np.ones(PIX, f32)
        t_final, acc = np.ones(PIX, f32), np.zeros((4, PIX), f32)
        done, exit_pos = np.zeros(PIX, bool), np.full(PIX, cnt, f32)
        for base in range(0, cnt, PIX):
            if done.all():
                break
            n = min(PIX, cnt - base)
            walked[t] += n
            for i in range(base, base + n):
                lanes = _LANES[masks[i]]
                lanes = lanes[~done[lanes]]
                r = seg[i]
                dx, dy = r[0] - px[lanes], r[1] - py[lanes]
                power = (f32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy)
                         - r[3] * dx * dy)
                gate = power <= 0
                a = np.fmin(r[5] * np.exp(np.where(gate, power, f32(0))),
                            f32(0.99))
                con = gate & (a >= f32(1 / 255))
                lanes, a = lanes[con], a[con]
                l_after = lsum[lanes] + np.log1p(-a)
                t_after = np.exp(l_after)
                ex = t_after < f32(1e-4)
                e = lanes[ex]
                t_final[e], exit_pos[e], done[e] = T[e], i, True
                k, a = lanes[~ex], a[~ex]
                w = a * T[k]
                for c in range(4):
                    acc[c, k] = acc[c, k] + w * r[6 + c]
                lsum[k], T[k] = l_after[~ex], t_after[~ex]
        t_final = np.where(done, t_final, T)
        for row, v in enumerate([*acc, t_final, lsum, exit_pos]):
            out[t, row, PATCH_PIXELS] = v
    return out, walked


def _case(name):
    """(JAX splats, h, w, bucket) of a named case."""
    n, spread, scales = 300, 1.0, (-3.5, -2.0)
    if name in ("dense", "bucket2", "bucket4"):
        n, spread, scales = 400, 0.4, (-3.0, -1.5)
    h = 72 if name == "partial" else 64
    params, _ = j_random_gaussians(np.random.default_rng(0), n=n,
                                   spread=spread, scale_range=scales)
    js = j_preprocess(params, j_camera_from_meta(j_make_camera(
        height=h, width=96, radius=4.0)), active_sh_degree=3)
    return js, h, 96, int(name[-1]) if name.startswith("bucket") else 1


def _canvas(tiles, ntx, nty, h, w):
    return (tiles[:, :5].reshape(nty, ntx, 5, 16, 16).transpose(2, 0, 3, 1, 4)
            .reshape(5, nty * 16, ntx * 16)[:, :h, :w])


@pytest.mark.parametrize("name", ["random", "dense", "partial", "bucket2",
                                  "bucket4"])
def test_mirror_mask_is_exact_and_matches_plain_and_pallas(name):
    js, h, w, bk = _case(name)
    ntx, nty = -(-w // 16), -(-h // 16)
    tr = tile_records(Splats2D(**{k: torch.tensor(np.asarray(v))
                                  for k, v in vars(js).items()}),
                      ntx, nty, RasterConfig(dup_capacity=CAP, bucket=bk))
    rects = None if tr.buckets is None else tr.buckets.rects
    rec, st, cn = tr.records.numpy(), tr.starts.numpy(), tr.counts.numpy()
    rn = None if rects is None else rects.numpy()
    got, walked = _kernel_a(rec, st, cn, ntx, nty, rn)
    ref, ref_walked = _kernel_a(rec, st, cn, ntx, nty, rn, masked=False)
    assert np.array_equal(got, ref) and np.array_equal(walked, ref_walked)
    # the mask skips work: (record, warp) steps with the bit clear
    sel = [(t, s) for t in range(len(cn)) for s in range(st[t], st[t] + cn[t])]
    tiles = torch.tensor([t for t, _ in sel])
    m = patch_masks(tr.records[[s for _, s in sel]][:, None], tiles, ntx,
                    nty, None if rects is None else rects[[s for _, s in sel]]
                    [:, None])[:, 0]
    bits = ((m[:, None] >> torch.arange(8)) & 1).float().mean()
    assert 0.0 < float(bits) < 0.9, float(bits)
    if name in ("dense", "bucket2", "bucket4"):
        assert cn.max() > PIX and (got[:, 6] < cn[:, None]).sum() > 100
    # a block stops only at a chunk boundary
    assert all(k == c or (k % PIX == 0 and k < c) for k, c in zip(walked, cn))

    want, _ = composite_tiles_plain(tr.records, tr.starts, tr.counts, ntx,
                                    nty, rects)
    d = np.abs(got[:, :5] - want[:, :5].numpy())
    assert d.mean() < 2e-4 and (d > 1e-3).mean() <= 0.01
    assert (got[:, 6] != want[:, 6].numpy()).mean() <= 0.01

    pal = j_rasterize_pallas(js, h, w, jnp.asarray(BG),
                             JRasterConfig(dup_capacity=CAP, bucket=bk),
                             interpret=True)
    img = _canvas(got, ntx, nty, h, w)
    render = img[:3] + img[4:5] * BG[:, None, None]
    for mine, theirs in ((render, pal["render"]), (img[3:4],
                                                   pal["invdepth"])):
        d = np.abs(mine - np.asarray(theirs))
        assert d.mean() < 2e-4 and (d > 1e-3).mean() < 0.01


def test_mirror_mask_is_exact_on_adversarial_segments():
    """Adversarial records in segments of 48 over a 4x4-tile view: the
    mirror with the mask equals the mirror without it bit for bit (NaN where
    NaN)."""
    rng = np.random.default_rng(1)
    rec = adversarial_records(rng, 128)
    rng.shuffle(rec)
    ntx = nty = 4
    seg = len(rec) // (ntx * nty)
    starts = np.arange(ntx * nty, dtype=np.int32) * seg
    counts = np.full(ntx * nty, seg, np.int32)
    for t in range(ntx * nty):    # each segment around its own tile
        rec[starts[t]:starts[t] + seg, 0] += (t % ntx) * 16
        rec[starts[t]:starts[t] + seg, 1] += (t // ntx) * 16
    with np.errstate(invalid="ignore", over="ignore"):
        got, walked = _kernel_a(rec, starts, counts, ntx, nty)
        ref, ref_walked = _kernel_a(rec, starts, counts, ntx, nty,
                                    masked=False)
    assert np.array_equal(got, ref, equal_nan=True)
    assert np.array_equal(walked, ref_walked)
    assert (got[:, 6] < seg).sum() > 0       # some pixels exit


@pytest.mark.parametrize("kind", KINDS)
def test_patch_masks_are_conservative(kind):
    i = KINDS.index(kind)
    n = 2000
    rec = adversarial_records(np.random.default_rng(2), n)[i * n:(i + 1) * n]
    # tile (2, 3) of a 6-column grid: pixel origin (32, 48)
    rec[:, 0] += 32
    rec[:, 1] += 48
    px = (32 + np.arange(PIX) % 16).astype(np.float32)
    py = (48 + np.arange(PIX) // 16).astype(np.float32)
    m = patch_masks(torch.from_numpy(rec)[None], torch.tensor([20]), 6,
                    8)[0].numpy()
    have = (m[:, None] >> np.arange(8)) & 1
    for fused in (False, True):
        con = pair_contributes(rec, px, py, fused)
        need = np.stack([con[:, _PATCH_OF == w].any(axis=1)
                         for w in range(8)], axis=1)
        bad = need & (have == 0)
        assert not bad.any(), (kind, fused, rec[bad.any(axis=1)][:3])
    c0, c1, c2, o = rec[:, 2], rec[:, 3], rec[:, 4], rec[:, 5]
    with np.errstate(invalid="ignore"):
        sound = (np.isfinite(o) & (c0 > 1e-12) & (c2 > 1e-12)
                 & (c0 * c2 > c1 * c1))
    assert (m[~sound] == 0xFF).all()
    if kind == "not positive definite":
        assert (~sound).all()
    elif kind in ("threshold opacity", "edge on a patch border",
                  "anisotropic", "generic"):
        assert (have == 0).mean() > 0.3    # the mask does clear bits
