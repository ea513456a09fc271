"""Kernel E's patch design (csrc/composite_jvp.cu) on the CPU.

Kernel E runs only on the card. Here its algorithm is mirrored in float32
numpy: kernel A's 8x4 warp patches (``PATCH_PIXELS``) and per-record patch
mask (``patch_masks``, the rect gate folded in), warps skipping the records
whose bit is clear, and per pixel the front-to-back walk with the tangent
of the log-transmittance sum, t_final and its tangent frozen at the exit.
Cases: a random scene, a dense one (segments of more than 256 records,
pixels that exit), a 72-row view (partial tiles), buckets of 2 and 4 with
rects, and the adversarial records of tests/patch_cases.py.

- With the mask and without it (the guard E<MASK=false>'s walk: every
  record but for the rect gate) the mirror is bitwise equal, primal rows
  0-6 and tangent rows 0-4, and its primal equals kernel A's mirror
  (tests/test_torch_fwd_patch.py) bit for bit.
- The mirror equals ``composite_tiles_jvp_plain`` at the knife-edge bound
  of the parity tests (primal rows 0-4; tangent rows per row relative to
  max |plain|; exit positions at most 1 % apart) and, on the random scene,
  the J·v of JAX's ``rasterize_pallas(mode="jvp")`` in interpret mode
  (render and invdepth, the records' tangents from the port's record
  gather under forward AD).

    python -m pytest tests/test_torch_jvp_patch.py -q
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

from gslm_tpu.ops.rasterize_pallas import rasterize_pallas as j_rasterize_pallas
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu_torch.ops.projection import Splats2D
from gslm_tpu_torch.ops.rasterize_cuda import (PATCH_PIXELS, PIX,
                                               composite_tiles_jvp_plain,
                                               tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
# pytest puts tests/ on sys.path; an installed ``tests`` package can shadow
# the name ``tests.patch_cases``
from patch_cases import adversarial_records
from test_torch_bwd_patch import knife_edge, port_case, segments, to_jax
from test_torch_fwd_patch import BG, CAP, _kernel_a
from torch_threads import one_thread  # noqa: F401 (autouse)

FIELDS = ("mean2d", "conic", "color", "opacity", "invdepth")


def _kernel_e(rec, tng, starts, counts, ntx, view_rows, rects=None,
              masked=True):
    """Kernel E in float32 numpy, all tiles at once, record slot by slot:
    (tiles (T, 7, 256), tiles_dot (T, 5, 256)). Thread k of a tile is pixel
    PATCH_PIXELS[k]; ``masked=False``: the guard's walk."""
    f32 = np.float32
    T = len(counts)
    tiles = np.arange(T)[:, None]
    px = ((tiles % ntx) * 16 + PATCH_PIXELS % 16).astype(f32)   # (T, 256)
    py = (((tiles // ntx) % view_rows) * 16
          + PATCH_PIXELS // 16).astype(f32)
    seg, idx, bits = segments(rec, starts, counts, ntx, view_rows, masked,
                              rects)
    tseg = tng[idx]
    z = np.zeros((T, PIX), f32)
    lsum, Tr, lsum_dot = z.copy(), np.ones((T, PIX), f32), z.copy()
    acc, dot = np.zeros((4, T, PIX), f32), np.zeros((4, T, PIX), f32)
    done = np.zeros((T, PIX), bool)
    exit_pos = np.repeat(counts[:, None], PIX, axis=1).astype(f32)
    for i in range(seg.shape[1]):
        r, d = seg[:, i, :, None], tseg[:, i, :, None]           # (T, 10, 1)
        walk = (i < counts)[:, None] & ((bits[:, i, None] >> np.arange(8))
                                        & 1 > 0)
        lanes = np.repeat(walk, 32, axis=1) & ~done
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            dx, dy = r[:, 0] - px, r[:, 1] - py
            power = (f32(-0.5) * (r[:, 2] * dx * dx + r[:, 4] * dy * dy)
                     - r[:, 3] * dx * dy)
            expp = np.exp(np.minimum(power, f32(0)))
            a_raw = r[:, 5] * expp
            a = np.minimum(a_raw, f32(0.99))
            con = lanes & (power <= 0) & (a >= f32(1 / 255))
            l_after = lsum + np.log1p(-a)
            t_after = np.exp(l_after)
            ex = con & (t_after < f32(1e-4))
            ok = con & ~ex
            T_dot = Tr * lsum_dot
            pow_dot = (-(r[:, 2] * dx + r[:, 3] * dy) * d[:, 0]
                       - (r[:, 4] * dy + r[:, 3] * dx) * d[:, 1]
                       - f32(0.5) * dx * dx * d[:, 2] - dx * dy * d[:, 3]
                       - f32(0.5) * dy * dy * d[:, 4])
            a_dot = d[:, 5] * expp + a_raw * pow_dot
            w = a * Tr
            w_dot = a_dot * Tr + a * T_dot
            for c in range(4):
                acc[c] = np.where(ok, acc[c] + w * r[:, 6 + c], acc[c])
                dot[c] = np.where(ok, dot[c] + (w_dot * r[:, 6 + c]
                                                + w * d[:, 6 + c]), dot[c])
            new_lsum_dot = lsum_dot - a_dot / (f32(1) - a)
        exit_pos = np.where(ex, f32(i), exit_pos)
        done |= ex
        lsum = np.where(ok, l_after, lsum)
        Tr = np.where(ok, t_after, Tr)
        lsum_dot = np.where(ok, new_lsum_dot, lsum_dot)
    out = np.zeros((T, 7, PIX), f32)
    out_dot = np.zeros((T, 5, PIX), f32)
    for row, v in enumerate([*acc, Tr, lsum, exit_pos]):
        out[:, row, PATCH_PIXELS] = v
    with np.errstate(invalid="ignore", over="ignore"):
        for row, v in enumerate([*dot, Tr * lsum_dot]):
            out_dot[:, row, PATCH_PIXELS] = v
    return out, out_dot


def _records(name):
    """(TileRecords, ntx, nty, h, w, splat fields, seeded record tangents
    (L, 10), each field at its own spread)."""
    sp, h, w, bk = port_case(name)
    ntx, nty = -(-w // 16), -(-h // 16)
    tr = tile_records(Splats2D(**sp), ntx, nty,
                      RasterConfig(dup_capacity=CAP, bucket=bk))
    rec = tr.records.numpy()
    tng = (np.random.default_rng(5).normal(0, 1, rec.shape)
           * rec.std(axis=0)).astype(np.float32)
    return tr, ntx, nty, h, w, sp, tng


@pytest.mark.parametrize("name", ["random", "dense", "partial", "bucket2",
                                  "bucket4"])
def test_mirror_mask_is_exact_and_matches_plain(name):
    tr, ntx, nty, h, w, sp, tng = _records(name)
    rects = None if tr.buckets is None else tr.buckets.rects
    rec, st, cn = tr.records.numpy(), tr.starts.numpy(), tr.counts.numpy()
    rn = None if rects is None else rects.numpy()
    got, got_dot = _kernel_e(rec, tng, st, cn, ntx, nty, rn)
    ref, ref_dot = _kernel_e(rec, tng, st, cn, ntx, nty, rn, masked=False)
    assert np.array_equal(got, ref) and np.array_equal(got_dot, ref_dot)
    assert np.array_equal(got, _kernel_a(rec, st, cn, ntx, nty, rn)[0])
    if name in ("dense", "bucket2", "bucket4"):
        assert cn.max() > PIX and (got[:, 6] < cn[:, None]).sum() > 100
    want, want_dot = composite_tiles_jvp_plain(
        tr.records, torch.from_numpy(tng), tr.starts, tr.counts, ntx, nty,
        rects)
    want, want_dot = want.numpy(), want_dot.numpy()
    assert knife_edge(got[:, :5], want[:, :5])
    assert (got[:, 6] != want[:, 6]).mean() <= 0.01
    for row in range(5):
        assert knife_edge(got_dot[:, row], want_dot[:, row]), (name, row)


def test_mirror_matches_pallas_jvp():
    """The mirror's image tangent, the records' tangents from the port's
    record gather under forward AD, against the J·v of JAX's Pallas JVP
    kernel in interpret mode."""
    tr, ntx, nty, h, w, sp, _ = _records("random")
    rng = np.random.default_rng(6)
    v = {k: rng.normal(0, 1, tuple(sp[k].shape)).astype(np.float32)
         * float(sp[k].std()) for k in FIELDS}
    js = to_jax(sp)

    def img(*fields):
        out = j_rasterize_pallas(
            js.replace(**dict(zip(FIELDS, fields))), h, w, jnp.asarray(BG),
            JRasterConfig(dup_capacity=CAP), interpret=True, mode="jvp")
        return out["render"], out["invdepth"]

    _, (want_rgb, want_inv) = jax.jvp(
        img, tuple(getattr(js, k) for k in FIELDS),
        tuple(jnp.asarray(v[k]) for k in FIELDS))
    with fwAD.dual_level():
        duals = dict(sp, **{k: fwAD.make_dual(sp[k], torch.from_numpy(v[k]))
                            for k in FIELDS})
        rec = tile_records(Splats2D(**duals), ntx, nty,
                           RasterConfig(dup_capacity=CAP)).records
        tng = fwAD.unpack_dual(rec).tangent.numpy()
    got, got_dot = _kernel_e(tr.records.numpy(), tng, tr.starts.numpy(),
                             tr.counts.numpy(), ntx, nty)
    canvas = (got_dot.reshape(nty, ntx, 5, 16, 16).transpose(2, 0, 3, 1, 4)
              .reshape(5, nty * 16, ntx * 16)[:, :h, :w])
    rgb_dot = canvas[:3] + canvas[4:5] * BG[:, None, None]
    assert knife_edge(rgb_dot, np.asarray(want_rgb))
    assert knife_edge(canvas[3:4], np.asarray(want_inv))


def test_mirror_mask_is_exact_on_adversarial_segments():
    """Adversarial records in segments of 48 over a 4x4-tile view, seeded
    tangents: the mirror with the mask equals the mirror without it bit for
    bit (NaN where NaN), primal and tangent."""
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
    tng = rng.normal(0, 1, rec.shape).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        got, got_dot = _kernel_e(rec, tng, starts, counts, ntx, nty)
        ref, ref_dot = _kernel_e(rec, tng, starts, counts, ntx, nty,
                                 masked=False)
    assert np.array_equal(got, ref, equal_nan=True)
    assert np.array_equal(got_dot, ref_dot, equal_nan=True)
    assert (got[:, 6] < seg).sum() > 0       # some pixels exit
