"""Differentiable tile rasterizer around kernels A, C, D and E
(csrc/composite_fwd.cu, csrc/composite_bwd.cu, csrc/composite_bucket_bwd.cu,
csrc/composite_jvp.cu).

Counterpart of ``rasterize_pallas`` (gslm_tpu/ops/rasterize_pallas.py,
mode "vjp"): stages 1-3 of the tile pipeline
(``duplicate_sort_ranges``), the depth-sorted record table gathered with
plain indexing (JAX also gathers outside its kernels), the per-tile (start,
count) segment table, the compositor, then canvas assembly and the
background blend ``render = rgb + t_final * bg``.

The compositor is a ``torch.autograd.Function`` (the vjp branch of
``_make_composite``): kernel A forward, kernel C backward from the exit
state kernel A saved.

Bucket binning (``RasterConfig.bucket`` > 1): stages 1-3 run on a
bucket×bucket-tile super-grid, so the sort and the gather move fewer
records, and every tile walks its parent bucket's segment. A record then
counts for a tile only when the tile's pixel origin lies in the record's
own tile rect (the rect gate; ``BucketSegments.rects``, a separate int32
tensor beside the 10 float fields): the tile walks exactly its bucket-1
records plus ones the tile-level cull would drop, whose alpha is below
1/255 on the whole tile, in the same depth order. The backward is kernel
D: kernel C's walk per tile into one scratch plane per member slot, then
a sum of the member tiles' cotangents of each record in slot order (kernel
C alone would overwrite them). The record gather ``table[order][rank]`` is
differentiated by PyTorch's indexing backward, a scatter-add onto the
Gaussians (JAX's ``_gather_records``); the JAX ``bwd_reduce="sortseg"``
reduction is XLA code, not a kernel, and is not ported.

Forward mode (the LM solver's J·v) goes through kernel E instead: when
the gathered records carry a forward-AD tangent, ``rasterize_cuda``
launches kernel E once on (primal, tangent) and makes the image a dual
tensor from its two outputs, as the ``custom_jvp`` of JAX's
``make_jvp_composite`` does (kernel A does not run). One residual function
thus serves J·v and Jᵀ·u; records that are dual AND record autograd raise.

``composite_tiles`` / ``composite_tiles_bwd`` /
``composite_tiles_bucket_bwd`` / ``composite_tiles_jvp`` launch their
kernels for CUDA tensors and take their plain versions (the same names with
``_plain``) for CPU tensors only. Kernels A, C, D and E give each warp an 8x4
pixel patch of the tile (``PATCH_PIXELS``) and skip the records their
per-record patch mask rules out; ``patch_masks`` is that mask's plain
version. ``composite_tiles_jvp_unmasked`` is kernel E without the mask, the
guard the tests and chip_smoke.py hold A and E to bit for bit, and
``composite_tiles_bwd_unmasked`` and ``composite_tiles_bucket_bwd_unmasked``
kernels C and D without it, the guards they hold C and D to; no render path
calls any of the three.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from gslm_tpu_torch import _build
from gslm_tpu_torch.ops.composite import (clip_alpha, composite_weights,
                                          exit_state)
from gslm_tpu_torch.ops.projection import TILE, Splats2D, quad_min_rect
from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                bucket_splats,
                                                duplicate_sort_ranges)
from gslm_tpu_torch.utils.profiling import span

PIX = TILE * TILE   # pixels per tile
NF = 10             # record fields: mean2d 2, conic 3, opacity, rgb 3, invdepth
IMG_ROWS = 5        # r, g, b, invdepth, t_final
OUT_ROWS = 7        # + the exit state: log-transmittance sum, exit position
BUCKET_SLOTS = 16   # kernel D's flags per record row: bucket² member slots
PATCH_W, PATCH_H = 8, 4   # kernel A's warp patches: 2 across, 4 down a tile
# the row-major tile pixel of each of kernel A's 256 threads: warp w owns
# the patch at (8 (w % 2), 4 (w // 2)), lane l its pixel (l % 8, l // 8)
PATCH_PIXELS = np.array(
    [(PATCH_H * (w // 2) + l // PATCH_W) * TILE + PATCH_W * (w % 2)
     + l % PATCH_W for w in range(PIX // 32) for l in range(32)])


class BucketSegments(NamedTuple):
    """The bucket-mode geometry beside the records (``bucket`` > 1).

    ``rects`` (L, 4) int32: each record's tile rect in pixels, [x0, x1) and
    [y0, y1) with y view-local; tile t walks a record only when its pixel
    origin lies inside. ``bstarts`` / ``bcounts`` (nseg,) int32: the bucket
    segments in bucket order (row-major over the super-grid; bucket rows
    wrap per view). ``bucket``: the bucket side in tiles."""
    rects: torch.Tensor
    bstarts: torch.Tensor
    bcounts: torch.Tensor
    bucket: int


class TileRecords(NamedTuple):
    """``tile_records``' output: tile t composites ``records[starts[t]:
    starts[t] + counts[t]]`` (its parent bucket's segment in bucket mode);
    ``totals`` (live, AABB) entry counts; ``buckets`` None at bucket 1."""
    records: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    totals: tuple
    buckets: BucketSegments | None


def bucket_of_tile(ntx: int, nty: int, view_rows: int, bucket: int,
                   device) -> torch.Tensor:
    """(ntx * nty,) the parent bucket of every tile; tile rows and bucket
    rows wrap per view (``view_rows`` divisible by ``bucket``)."""
    t = torch.arange(ntx * nty, device=device)
    ty, tx = torch.div(t, ntx, rounding_mode="floor"), t % ntx
    by = (torch.div(ty, view_rows, rounding_mode="floor")
          * (view_rows // bucket)
          + torch.div(ty % view_rows, bucket, rounding_mode="floor"))
    return by * _cdiv(ntx, bucket) + torch.div(tx, bucket,
                                               rounding_mode="floor")


def tile_records(splats: Splats2D, ntx: int, nty: int, config: RasterConfig,
                 view_rows: int | None = None) -> TileRecords:
    """Stages 1-3 plus the record gather. The records, (n, 10) float32, are
    differentiable in the splats' float fields; the segments cover their
    rows exactly, in tile order (bucket order in bucket mode).

    With ``config.bucket`` > 1 the front end runs on the bucket grid
    (rects coarsened by ``bucket_splats``, cull cells of bucket pixels) and
    every tile's (start, count) is its parent bucket's
    (rasterize_pallas.py:1139-1160,1255-1263)."""
    with span("gslm.front_end"):
        if view_rows is None:
            view_rows = nty
        bk = config.bucket
        kw = dict(cull=config.cull, live_capacity=config.live_capacity)
        if bk == 1:
            order, rank, starts, ends, totals = duplicate_sort_ranges(
                splats, ntx, nty, config.dup_capacity, view_rows=view_rows,
                **kw)
        else:
            if view_rows % bk:
                raise ValueError(f"bucket={bk} needs view_rows ({view_rows}) "
                                 f"divisible by it")
            vrow_b = view_rows // bk
            order, rank, starts, ends, totals = duplicate_sort_ranges(
                bucket_splats(splats, bk), _cdiv(ntx, bk),
                (nty // view_rows) * vrow_b, config.dup_capacity,
                view_rows=vrow_b, tile_px=TILE * bk, **kw)
        with span("gslm.front_end.gather"):
            table = torch.cat([splats.mean2d, splats.conic,
                               splats.opacity[:, None], splats.color,
                               splats.invdepth[:, None]], dim=1)[order]
            records = table[rank].contiguous()
            starts, counts = (starts.to(torch.int32),
                              (ends - starts).to(torch.int32))
            if bk == 1:
                return TileRecords(records, starts, counts, totals, None)
            # the rect gate's bounds in pixels, y view-local (:1202-1214)
            rmin, rmax = splats.rect_min, splats.rect_max
            y0 = torch.remainder(rmin[:, 1], view_rows)
            rect = torch.stack([rmin[:, 0], rmax[:, 0], y0,
                                y0 + rmax[:, 1] - rmin[:, 1]], dim=1) * TILE
            rects = rect.to(torch.int32)[order][rank].contiguous()
            bid = bucket_of_tile(ntx, nty, view_rows, bk, records.device)
            return TileRecords(records, starts[bid], counts[bid], totals,
                               BucketSegments(rects, starts, counts, bk))


def _tile_pixels(tiles: torch.Tensor, ntx: int, view_rows: int):
    """(G,) tile ids → pixel x/y (G, 256); rows wrap modulo view_rows."""
    lin = torch.arange(PIX, device=tiles.device)
    tx = (tiles % ntx) * TILE
    ty = torch.remainder(torch.div(tiles, ntx, rounding_mode="floor"),
                         view_rows) * TILE
    return ((tx[:, None] + lin % TILE).float(),
            (ty[:, None] + lin // TILE).float())


def _tile_chunks(counts: torch.Tensor, max_elems: int):
    """Consecutive tile ranges ``(t0, t1, longest segment)`` of at most
    ``max_elems`` (record, pixel) pairs each (one tile at least)."""
    cnt = counts.cpu().numpy().astype(np.int64)
    ntiles = cnt.shape[0]
    t0 = 0
    while t0 < ntiles:
        t1, s_max = t0, 0
        while t1 < ntiles:
            s_new = max(s_max, int(cnt[t1]))
            if t1 > t0 and (t1 - t0 + 1) * s_new * PIX > max_elems:
                break
            s_max, t1 = s_new, t1 + 1
        yield t0, t1, s_max
        t0 = t1


def _default_max_elems(dev: torch.device) -> int:
    return 1 << 25 if dev.type == "cuda" else 1 << 22


def composite_tiles_plain(records: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, ntx: int, view_rows: int,
                          rects: torch.Tensor | None = None,
                          max_elems: int | None = None):
    """Plain PyTorch version of kernel A: every tile's whole segment in
    closed form (``composite_weights``, ``exit_state``), over chunks of
    tiles of at most ``max_elems`` (record, pixel) pairs, records outside
    the tile's rect gate (``rects``, bucket mode) left out. Returns
    ``(tiles (ntiles, 7, 256), walked (ntiles,) i32)``; it walks every
    record of every segment.

    Sums over records run as sequential cumsums, so a tile's result does
    not depend on which tiles share its chunk (a batched render equals the
    single-view render bit for bit on the CPU)."""
    dev = records.device
    ntiles = counts.shape[0]
    out = torch.zeros(ntiles, OUT_ROWS, PIX, device=dev)
    out[:, 4] = 1.0
    out[:, 6] = counts[:, None].float()
    for t0, t1, s_max in _tile_chunks(counts, max_elems
                                      or _default_max_elems(dev)):
        if s_max > 0:
            out[t0:t1] = _composite_chunk(records, starts[t0:t1].long(),
                                          counts[t0:t1].long(),
                                          torch.arange(t0, t1, device=dev),
                                          s_max, ntx, view_rows, rects)
    return out, counts.to(torch.int32)


def rect_gate(rects: torch.Tensor, tiles: torch.Tensor, ntx: int,
              view_rows: int) -> torch.Tensor:
    """rects (G, S, 4) of the records G tiles walk → (G, S) bool: the
    tile's pixel origin lies in the record's rect (the kernels'
    ``rect_gate``)."""
    txc = ((tiles % ntx) * TILE)[:, None]
    tyc = (torch.remainder(torch.div(tiles, ntx, rounding_mode="floor"),
                           view_rows) * TILE)[:, None]
    return ((txc >= rects[..., 0]) & (txc < rects[..., 1])
            & (tyc >= rects[..., 2]) & (tyc < rects[..., 3]))


def patch_masks(records: torch.Tensor, tiles: torch.Tensor, ntx: int,
                view_rows: int, rects: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Plain version of kernel A's per-record patch mask: records (G, S, 10)
    that G tiles (ids ``tiles`` (G,)) walk → (G, S) int32, bit w set unless
    the record's alpha provably stays below 1/255 on every pixel of the
    tile's 8x4 patch w (``PATCH_PIXELS``). The test is the tile front end's
    (``quad_min_rect`` over the patch's pixel rectangle) with the kernel's
    rounding term: clear iff qmin (1 - 1e-4) - 4e-6 S > s2 + 1e-3, S the
    terms' magnitudes at the rectangle's largest |dx| and |dy|. All bits are
    set for a non-finite opacity, c0 or c2 at or below 1e-12, or c0 c2 <=
    c1²; with ``rects`` (G, S, 4) a record outside the rect gate gets 0.
    Used by the tests and chip_smoke.py's counts, not by the render path."""
    mx, my, a, b, c, o = (records[..., k] for k in range(6))
    txc = ((tiles % ntx) * TILE)[:, None]
    tyc = (torch.remainder(torch.div(tiles, ntx, rounding_mode="floor"),
                           view_rows) * TILE)[:, None]
    s2 = 2.0 * torch.log(torch.clamp(o * 255.0, min=1e-12))
    mask = torch.zeros(mx.shape, dtype=torch.int32, device=records.device)
    for w in range(PIX // 32):
        x0 = txc + PATCH_W * (w % 2)
        y0 = tyc + PATCH_H * (w // 2)
        dx0, dx1 = x0.float() - mx, (x0 + PATCH_W - 1).float() - mx
        dy0, dy1 = y0.float() - my, (y0 + PATCH_H - 1).float() - my
        qmin = quad_min_rect(a, b, c, dx0, dx1, dy0, dy1)
        X = torch.maximum(dx0.abs(), dx1.abs())
        Y = torch.maximum(dy0.abs(), dy1.abs())
        S = a * X * X + 2.0 * b.abs() * X * Y + c * Y * Y
        keep = ~(qmin * (1.0 - 1e-4) - 4e-6 * S > s2 + 1e-3)
        mask |= keep.to(torch.int32) << w
    sound = torch.isfinite(o) & (a > 1e-12) & (c > 1e-12) & (a * c > b * b)
    mask = torch.where(sound, mask, 0xFF)
    if rects is not None:
        mask = torch.where(rect_gate(rects, tiles, ntx, view_rows), mask, 0)
    return mask


def _composite_chunk(records, starts, counts, tiles, S, ntx, view_rows,
                     rects=None):
    """Closed-form composite of G tiles over S record slots → (G, 7, 256);
    rows 0-4 are differentiable in ``records``, rows 5-6 (the exit state)
    are not. Records the rect gate drops count as absent."""
    slot = torch.arange(S, device=records.device)
    valid = slot[None] < counts[:, None]                         # (G, S)
    idx = torch.clamp(starts[:, None] + slot[None], 0, records.shape[0] - 1)
    if rects is not None:
        valid = valid & rect_gate(rects[idx], tiles, ntx, view_rows)
    rec = records[idx]                                           # (G, S, 10)
    px, py = _tile_pixels(tiles, ntx, view_rows)                 # (G, 256)
    dx = rec[..., 0, None] - px[:, None]                         # (G, S, 256)
    dy = rec[..., 1, None] - py[:, None]
    power = (-0.5 * (rec[..., 2, None] * dx * dx + rec[..., 4, None] * dy * dy)
             - rec[..., 3, None] * dx * dy)
    gate = valid[..., None] & (power <= 0.0)
    power = torch.where(gate, power, -100.0)
    alpha = clip_alpha(rec[..., 5, None] * torch.exp(power)).transpose(0, 1)
    weights, t_final = composite_weights(alpha)                  # (S, G, 256)
    lsum, pos = exit_state(alpha, counts[:, None])
    feat = rec[..., 6:10].transpose(0, 1)                        # (S, G, 4)
    acc = torch.cumsum(weights[..., None] * feat[:, :, None], dim=0)[-1]
    return torch.cat([acc.permute(0, 2, 1), t_final[:, None], lsum[:, None],
                      pos[:, None]], dim=1)


def _check_records(records, starts, counts):
    if (records.device.type != "cuda" or records.dtype != torch.float32
            or records.ndim != 2 or records.shape[1] != NF):
        raise TypeError(f"records must be CUDA float32 (L, {NF}), got "
                        f"{tuple(records.shape)} {records.dtype} on "
                        f"{records.device}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.device != records.device:
            raise TypeError(f"{name} must be int32 on {records.device}")
    return records.contiguous(), starts.contiguous(), counts.contiguous()


def _rects_ptr(records, rects) -> int | None:
    """The rect table's device pointer (None, a null pointer, without
    one), after checking it is int32 (L, 4) beside ``records``."""
    if rects is None:
        return None
    if (rects.dtype != torch.int32 or rects.device != records.device
            or tuple(rects.shape) != (records.shape[0], 4)
            or not rects.is_contiguous()):
        raise TypeError(f"rects must be contiguous int32 "
                        f"({records.shape[0]}, 4) on {records.device}, got "
                        f"{tuple(rects.shape)} {rects.dtype} on "
                        f"{rects.device}")
    return rects.data_ptr()


def _check_tile_rows(records, ntiles, **named):
    """Each named tensor must be float32 (ntiles, rows, 256) beside
    ``records``; returns them contiguous, in order."""
    out = []
    for name, (t, rows) in named.items():
        t = t.contiguous()
        if (t.dtype != torch.float32 or t.device != records.device
                or tuple(t.shape) != (ntiles, rows, PIX)):
            raise TypeError(f"{name} must be float32 ({ntiles}, {rows}, "
                            f"{PIX}) on {records.device}, got "
                            f"{tuple(t.shape)} {t.dtype} on {t.device}")
        out.append(t)
    return out


def composite_tiles(records: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, ntx: int, view_rows: int,
                    rects: torch.Tensor | None = None):
    """Composite every tile's segment → ``(tiles (ntiles, 7, 256) f32 rows
    [r, g, b, invdepth, t_final, exit lsum, exit position], walked
    (ntiles,) i32)``. ``rects`` (bucket mode): each record's rect gate;
    exit positions are then in bucket-segment coordinates.

    A CUDA tensor goes through kernel A (or the call raises); a CPU tensor
    takes the plain version."""
    if records.device.type == "cpu":
        return composite_tiles_plain(records, starts, counts, ntx, view_rows,
                                     rects)
    records, starts, counts = _check_records(records, starts, counts)
    ntiles = counts.shape[0]
    out = torch.empty(ntiles, OUT_ROWS, PIX, device=records.device)
    walked = torch.empty(ntiles, dtype=torch.int32, device=records.device)
    lib = _build.load("composite_fwd")
    rc = lib.composite_fwd(records.data_ptr(), _rects_ptr(records, rects),
                           starts.data_ptr(), counts.data_ptr(), ntiles, ntx,
                           view_rows, out.data_ptr(), walked.data_ptr(),
                           torch.cuda.current_stream(records.device).cuda_stream)
    _build.check(rc, "composite_fwd")
    composite_tiles.launches += 1
    return out, walked


composite_tiles.launches = 0   # kernel A launches in this process


def composite_tiles_bwd_plain(records: torch.Tensor, starts: torch.Tensor,
                              counts: torch.Tensor, ntx: int, view_rows: int,
                              gtiles: torch.Tensor, depth_grad: bool = True,
                              rects: torch.Tensor | None = None,
                              max_elems: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel C: ``torch.autograd.grad`` of the
    closed-form composite (rows 0-4 of ``composite_tiles_plain``, rect-gated
    with ``rects``) against ``gtiles[:, :5]``, one chunk of tiles of at most
    ``max_elems`` pairs at a time, so memory stays bounded; tiles that share
    records (bucket mode) add their terms. Without ``depth_grad`` the
    invdepth cotangent is dropped, as kernel C drops it. Returns drec
    (L, 10)."""
    dev = records.device
    g = gtiles[:, :IMG_ROWS]
    if not depth_grad:
        g = g.clone()
        g[:, 3] = 0.0
    drec = torch.zeros_like(records)
    st = starts.cpu().numpy().astype(np.int64)
    cnt = counts.cpu().numpy().astype(np.int64)
    for t0, t1, s_max in _tile_chunks(counts, max_elems
                                      or _default_max_elems(dev)):
        if s_max == 0:
            continue
        lo = int(st[t0:t1].min())
        hi = int((st[t0:t1] + cnt[t0:t1]).max())
        with torch.enable_grad():
            sub = records[lo:hi].detach().requires_grad_(True)
            out = _composite_chunk(sub, starts[t0:t1].long() - lo,
                                   counts[t0:t1].long(),
                                   torch.arange(t0, t1, device=dev), s_max,
                                   ntx, view_rows,
                                   None if rects is None else rects[lo:hi])
            (d,) = torch.autograd.grad(out[:, :IMG_ROWS], sub, g[t0:t1])
        drec[lo:hi] += d
    return drec


def composite_tiles_bwd(records: torch.Tensor, starts: torch.Tensor,
                        counts: torch.Tensor, ntx: int, view_rows: int,
                        gtiles: torch.Tensor, state: torch.Tensor,
                        depth_grad: bool = True) -> torch.Tensor:
    """Cotangent of every record field, drec (L, 10), from the image
    cotangent ``gtiles`` (ntiles, 5, 256) and kernel A's exit state
    ``state`` (ntiles, 2, 256).

    A CUDA tensor goes through kernel C (kernel A's 8x4 patches and patch
    mask, a fixed-order per-record sum; or the call raises); a CPU tensor
    takes the plain version, which recomputes the forward and ignores
    ``state``."""
    if records.device.type == "cpu":
        return composite_tiles_bwd_plain(records, starts, counts, ntx,
                                         view_rows, gtiles, depth_grad)
    drec = _bwd_launch("composite_bwd", records, starts, counts, ntx,
                       view_rows, gtiles, state, depth_grad)
    composite_tiles_bwd.launches += 1
    return drec


composite_tiles_bwd.launches = 0   # kernel C launches in this process


def composite_tiles_bwd_unmasked(records: torch.Tensor, starts: torch.Tensor,
                                 counts: torch.Tensor, ntx: int,
                                 view_rows: int, gtiles: torch.Tensor,
                                 state: torch.Tensor,
                                 depth_grad: bool = True) -> torch.Tensor:
    """``composite_tiles_bwd`` through the guard C<MASK=false>: every patch
    bit set, so every warp walks every record below its own largest exit.
    Kernel C's drec is held equal to its drec bit for bit (the tests,
    chip_smoke.py); no render path calls it. A CPU tensor takes the plain
    version."""
    if records.device.type == "cpu":
        return composite_tiles_bwd_plain(records, starts, counts, ntx,
                                         view_rows, gtiles, depth_grad)
    drec = _bwd_launch("composite_bwd_unmasked", records, starts, counts, ntx,
                       view_rows, gtiles, state, depth_grad)
    composite_tiles_bwd_unmasked.launches += 1
    return drec


composite_tiles_bwd_unmasked.launches = 0   # C<MASK=false> launches


def _bwd_launch(fn: str, records, starts, counts, ntx: int, view_rows: int,
                gtiles, state, depth_grad: bool) -> torch.Tensor:
    """Kernel C's entry ``fn`` of the composite_bwd library on CUDA
    tensors: drec (L, 10)."""
    records, starts, counts = _check_records(records, starts, counts)
    ntiles = counts.shape[0]
    gtiles, state = _check_tile_rows(records, ntiles,
                                     gtiles=(gtiles[:, :IMG_ROWS], IMG_ROWS),
                                     state=(state, 2))
    drec = torch.empty_like(records)
    lib = _build.load("composite_bwd")
    rc = getattr(lib, fn)(records.data_ptr(), starts.data_ptr(),
                          counts.data_ptr(), ntiles, ntx, view_rows,
                          gtiles.data_ptr(), state.data_ptr(),
                          int(depth_grad), drec.data_ptr(),
                          torch.cuda.current_stream(records.device).cuda_stream)
    _build.check(rc, fn)
    return drec


def composite_tiles_bucket_bwd_plain(records: torch.Tensor,
                                     buckets: BucketSegments, ntx: int,
                                     view_rows: int, gtiles: torch.Tensor,
                                     depth_grad: bool = True,
                                     max_elems: int | None = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of kernel D: autograd of the rect-gated closed
    form of every tile over its parent bucket's segment
    (``composite_tiles_bwd_plain``, whose chunks add the member tiles'
    terms of each record). Returns drec (L, 10)."""
    bid = bucket_of_tile(ntx, gtiles.shape[0] // ntx, view_rows,
                         buckets.bucket, records.device)
    return composite_tiles_bwd_plain(
        records, buckets.bstarts[bid], buckets.bcounts[bid], ntx, view_rows,
        gtiles, depth_grad, rects=buckets.rects, max_elems=max_elems)


def composite_tiles_bucket_bwd(records: torch.Tensor,
                               buckets: BucketSegments, ntx: int,
                               view_rows: int, gtiles: torch.Tensor,
                               state: torch.Tensor,
                               depth_grad: bool = True) -> torch.Tensor:
    """Bucket mode's cotangent of every record field, drec (L, 10): for
    each record of bucket b's segment, the sum over b's member tiles of the
    terms kernel C computes for one tile, each tile walking the segment
    under the rect gate from its own exit state. ``gtiles`` (ntiles, 5,
    256) and kernel A's exit state ``state`` (ntiles, 2, 256) are in tile
    order.

    A CUDA tensor goes through kernel D (one block per tile with kernel C's
    walk, each member's sums to scratch, then a fixed-order sum per row; or
    the call raises); a CPU tensor takes the plain version, which
    recomputes the forward and ignores ``state``."""
    if records.device.type == "cpu":
        return composite_tiles_bucket_bwd_plain(records, buckets, ntx,
                                                view_rows, gtiles,
                                                depth_grad)
    drec = _bucket_bwd_launch("composite_bucket_bwd", records, buckets, ntx,
                              view_rows, gtiles, state, depth_grad)
    composite_tiles_bucket_bwd.launches += 1
    return drec


composite_tiles_bucket_bwd.launches = 0   # kernel D launches in this process


def composite_tiles_bucket_bwd_unmasked(records: torch.Tensor,
                                        buckets: BucketSegments, ntx: int,
                                        view_rows: int, gtiles: torch.Tensor,
                                        state: torch.Tensor,
                                        depth_grad: bool = True
                                        ) -> torch.Tensor:
    """``composite_tiles_bucket_bwd`` through the guard D<MASK=false>: every
    patch bit set inside the rect gate. Kernel D's drec is held equal to
    its drec bit for bit (the tests, chip_smoke.py); no render path calls
    it. A CPU tensor takes the plain version."""
    if records.device.type == "cpu":
        return composite_tiles_bucket_bwd_plain(records, buckets, ntx,
                                                view_rows, gtiles,
                                                depth_grad)
    drec = _bucket_bwd_launch("composite_bucket_bwd_unmasked", records,
                              buckets, ntx, view_rows, gtiles, state,
                              depth_grad)
    composite_tiles_bucket_bwd_unmasked.launches += 1
    return drec


composite_tiles_bucket_bwd_unmasked.launches = 0   # D<MASK=false> launches


def _bucket_bwd_launch(fn: str, records, buckets: BucketSegments, ntx: int,
                       view_rows: int, gtiles, state,
                       depth_grad: bool) -> torch.Tensor:
    """Kernel D's entry ``fn`` of the composite_bucket_bwd library on CUDA
    tensors: drec (L, 10). The wrapper allocates the walk's scratch: each
    member slot's sums (bucket², L, 10) and a flag per (row, slot)."""
    records, bstarts, bcounts = _check_records(records, buckets.bstarts,
                                               buckets.bcounts)
    ntiles = gtiles.shape[0]
    bk = buckets.bucket
    if ntiles % ntx or (ntiles // ntx) % view_rows or view_rows % bk \
            or bk * bk > BUCKET_SLOTS:
        raise ValueError(f"{ntiles} tiles of {ntx} columns do not stack "
                         f"views of {view_rows} rows in buckets of {bk}")
    gtiles, state = _check_tile_rows(records, ntiles,
                                     gtiles=(gtiles[:, :IMG_ROWS], IMG_ROWS),
                                     state=(state, 2))
    n = records.shape[0]
    drec = torch.empty_like(records)
    part = torch.empty(bk * bk, n, NF, device=records.device)
    flags = torch.empty(n, BUCKET_SLOTS, dtype=torch.uint8,
                        device=records.device)
    lib = _build.load("composite_bucket_bwd")
    rc = getattr(lib, fn)(
        records.data_ptr(), _rects_ptr(records, buckets.rects),
        bstarts.data_ptr(), bcounts.data_ptr(), bcounts.shape[0], n, ntx,
        ntiles // ntx, view_rows, bk, gtiles.data_ptr(), state.data_ptr(),
        int(depth_grad), part.data_ptr(), flags.data_ptr(), drec.data_ptr(),
        torch.cuda.current_stream(records.device).cuda_stream)
    _build.check(rc, fn)
    return drec


def _forward_ad_level():
    """The active forward-AD level, or a new one (levels do not nest)."""
    return (contextlib.nullcontext() if fwAD._current_level >= 0
            else fwAD.dual_level())


def composite_tiles_jvp_plain(records: torch.Tensor, tangents: torch.Tensor,
                              starts: torch.Tensor, counts: torch.Tensor,
                              ntx: int, view_rows: int,
                              rects: torch.Tensor | None = None,
                              max_elems: int | None = None):
    """Plain PyTorch version of kernel E: forward-mode AD of the closed-form
    composite (``_composite_chunk``) along ``tangents``, over the same tile
    chunks as ``composite_tiles_plain``. Returns ``(tiles (ntiles, 7, 256),
    tiles_dot (ntiles, 5, 256))``; ``tiles`` is ``composite_tiles_plain``'s
    output."""
    dev = records.device
    ntiles = counts.shape[0]
    out = torch.zeros(ntiles, OUT_ROWS, PIX, device=dev)
    out[:, 4] = 1.0
    out[:, 6] = counts[:, None].float()
    out_dot = torch.zeros(ntiles, IMG_ROWS, PIX, device=dev)
    with torch.no_grad(), _forward_ad_level():
        dual = fwAD.make_dual(records, tangents)
        for t0, t1, s_max in _tile_chunks(counts, max_elems
                                          or _default_max_elems(dev)):
            if s_max > 0:
                o = _composite_chunk(dual, starts[t0:t1].long(),
                                     counts[t0:t1].long(),
                                     torch.arange(t0, t1, device=dev),
                                     s_max, ntx, view_rows, rects)
                primal, tangent = fwAD.unpack_dual(o)
                out[t0:t1] = primal
                out_dot[t0:t1] = tangent[:, :IMG_ROWS]
    return out, out_dot


def _jvp_launch(fn: str, records, tangents, starts, counts, ntx: int,
                view_rows: int, rects):
    """Kernel E's entry ``fn`` of the composite_jvp library on CUDA
    tensors: ``(tiles (ntiles, 7, 256), tiles_dot (ntiles, 5, 256))``."""
    records, starts, counts = _check_records(records, starts, counts)
    tangents = tangents.contiguous()
    if (tangents.dtype != torch.float32 or tangents.device != records.device
            or tangents.shape != records.shape):
        raise TypeError(f"tangents must be float32 {tuple(records.shape)} on "
                        f"{records.device}, got {tuple(tangents.shape)} "
                        f"{tangents.dtype} on {tangents.device}")
    ntiles = counts.shape[0]
    out = torch.empty(ntiles, OUT_ROWS, PIX, device=records.device)
    out_dot = torch.empty(ntiles, IMG_ROWS, PIX, device=records.device)
    lib = _build.load("composite_jvp")
    rc = getattr(lib, fn)(records.data_ptr(), tangents.data_ptr(),
                          _rects_ptr(records, rects), starts.data_ptr(),
                          counts.data_ptr(), ntiles, ntx, view_rows,
                          out.data_ptr(), out_dot.data_ptr(),
                          torch.cuda.current_stream(records.device).cuda_stream)
    _build.check(rc, fn)
    return out, out_dot


def composite_tiles_jvp(records: torch.Tensor, tangents: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor, ntx: int,
                        view_rows: int, rects: torch.Tensor | None = None):
    """Composite every tile's segment and its tangent along ``tangents``
    (L, 10) → ``(tiles (ntiles, 7, 256) f32, kernel A's rows; tiles_dot
    (ntiles, 5, 256) f32 rows [r, g, b, invdepth, t_final])``; ``rects``
    as for ``composite_tiles``.

    A CUDA tensor goes through kernel E (kernel A's 8x4 patches and patch
    mask; or the call raises); a CPU tensor takes the plain version."""
    if records.device.type == "cpu":
        return composite_tiles_jvp_plain(records, tangents, starts, counts,
                                         ntx, view_rows, rects)
    out = _jvp_launch("composite_jvp", records, tangents, starts, counts, ntx,
                      view_rows, rects)
    composite_tiles_jvp.launches += 1
    return out


composite_tiles_jvp.launches = 0   # kernel E launches in this process


def composite_tiles_jvp_unmasked(records: torch.Tensor,
                                 tangents: torch.Tensor, starts: torch.Tensor,
                                 counts: torch.Tensor, ntx: int,
                                 view_rows: int,
                                 rects: torch.Tensor | None = None):
    """``composite_tiles_jvp`` through the guard E<MASK=false>: no patch
    mask, every record's alpha through ``pair_alpha``. Kernel A's rows and
    the masked E's primal are held equal to its primal bit for bit (the
    tests, chip_smoke.py); no render path calls it. A CPU tensor takes the
    plain version."""
    if records.device.type == "cpu":
        return composite_tiles_jvp_plain(records, tangents, starts, counts,
                                         ntx, view_rows, rects)
    out = _jvp_launch("composite_jvp_unmasked", records, tangents, starts,
                      counts, ntx, view_rows, rects)
    composite_tiles_jvp_unmasked.launches += 1
    return out


composite_tiles_jvp_unmasked.launches = 0   # E<MASK=false> launches


def composite_image_rows(records, starts, counts, ntx: int, view_rows: int,
                         depth_grad: bool,
                         buckets: BucketSegments | None = None
                         ) -> torch.Tensor:
    """Rows 0-4 of every tile's composite, differentiable in ``records`` in
    either mode: reverse mode through ``Composite`` (kernel A, then C, or D
    in bucket mode), forward mode through kernel E when ``records`` carries
    a forward-AD tangent."""
    primal, tangent = fwAD.unpack_dual(records)
    if tangent is None:
        return Composite.apply(records, starts, counts, ntx, view_rows,
                               depth_grad, buckets)[0][:, :IMG_ROWS]
    if records.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "records carry a forward-AD tangent and record autograd: "
            "double-mode differentiation of the compositor is not supported")
    tiles, tiles_dot = composite_tiles_jvp(
        primal, tangent, starts, counts, ntx, view_rows,
        None if buckets is None else buckets.rects)
    return fwAD.make_dual(tiles[:, :IMG_ROWS], tiles_dot)


class Composite(torch.autograd.Function):
    """Kernel A with kernel C as its VJP, or kernel D in bucket mode (the
    vjp branches of gslm_tpu's ``_make_composite``). Only rows 0-4 of the
    output carry gradient; the exit state in rows 5-6 feeds the backward.
    ``buckets`` (None at bucket 1) holds index tensors only, so it rides on
    ``ctx`` instead of ``save_for_backward``."""

    @staticmethod
    def forward(ctx, records, starts, counts, ntx: int, view_rows: int,
                depth_grad: bool, buckets: BucketSegments | None):
        with span("gslm.composite_fwd"):
            tiles, walked = composite_tiles(
                records, starts, counts, ntx, view_rows,
                None if buckets is None else buckets.rects)
        ctx.save_for_backward(records, starts, counts, tiles)
        ctx.geometry = (ntx, view_rows, depth_grad)
        ctx.buckets = buckets
        ctx.mark_non_differentiable(walked)
        return tiles, walked

    @staticmethod
    def backward(ctx, gtiles, _):
        records, starts, counts, tiles = ctx.saved_tensors
        ntx, view_rows, depth_grad = ctx.geometry
        with span("gslm.composite_bwd"):
            if ctx.buckets is None:
                drec = composite_tiles_bwd(records, starts, counts, ntx,
                                           view_rows, gtiles[:, :IMG_ROWS],
                                           tiles[:, IMG_ROWS:], depth_grad)
            else:
                drec = composite_tiles_bucket_bwd(
                    records, ctx.buckets, ntx, view_rows,
                    gtiles[:, :IMG_ROWS], tiles[:, IMG_ROWS:], depth_grad)
        return drec, None, None, None, None, None, None


def rasterize_cuda(splats: Splats2D, height: int, width: int,
                   bg: torch.Tensor, config: RasterConfig,
                   view_rows: int | None = None) -> dict:
    """Composite splats over a (height, width) canvas, differentiably in the
    splats' float fields.

    Returns dict(render (3,H,W), invdepth (1,H,W), n_duplicates, overflow,
    max_tile_load). ``view_rows``: tile rows per view of a stacked
    multi-view canvas (splat coordinates are view-local)."""
    ntx, nty = _cdiv(width, TILE), _cdiv(height, TILE)
    if view_rows is None:
        view_rows = nty
    tr = tile_records(splats, ntx, nty, config, view_rows)
    tiles = composite_image_rows(tr.records, tr.starts, tr.counts, ntx,
                                 view_rows, config.depth_grad, tr.buckets)

    canvas = (tiles.reshape(nty, ntx, IMG_ROWS, TILE, TILE)
              .permute(2, 0, 3, 1, 4)
              .reshape(IMG_ROWS, nty * TILE, ntx * TILE)[:, :height, :width])
    rgb, invd, t_final = canvas[0:3], canvas[3:4], canvas[4:5]
    total_live, total_aabb = tr.totals
    overflow = ((total_live > config.eff_capacity())
                | (total_aabb > config.dup_capacity))
    return {
        "render": rgb + t_final * bg[:, None, None],
        "invdepth": invd,
        "n_duplicates": total_live,
        "overflow": overflow.to(torch.int32),
        "max_tile_load": tr.counts.max(),
    }
