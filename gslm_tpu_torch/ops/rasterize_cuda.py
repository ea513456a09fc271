"""Differentiable tile rasterizer around kernels A, C and E
(csrc/composite_fwd.cu, csrc/composite_bwd.cu, csrc/composite_jvp.cu).

Counterpart of ``rasterize_pallas`` (gslm_tpu/ops/rasterize_pallas.py,
bucket = 1, mode "vjp"): stages 1-3 of the tile pipeline
(``duplicate_sort_ranges``), the depth-sorted record table gathered with
plain indexing (JAX also gathers outside its kernels), the per-tile (start,
count) segment table, the compositor, then canvas assembly and the
background blend ``render = rgb + t_final * bg``.

The compositor is a ``torch.autograd.Function`` (the vjp branch of
``_make_composite``): kernel A forward, kernel C backward from the exit
state kernel A saved. The record gather ``table[order][rank]`` is
differentiated by PyTorch's indexing backward, a scatter-add onto the
Gaussians (JAX's ``_gather_records``); the JAX ``bwd_reduce="sortseg"``
reduction is XLA code, not a kernel, and is not ported.

Forward mode (the LM solver's J·v) goes through kernel E instead: when
the gathered records carry a forward-AD tangent, ``rasterize_cuda``
launches kernel E once on (primal, tangent) and makes the image a dual
tensor from its two outputs, as the ``custom_jvp`` of JAX's
``make_jvp_composite`` does (kernel A does not run). One residual function
thus serves J·v and Jᵀ·u; records that are dual AND record autograd raise.

``composite_tiles`` / ``composite_tiles_bwd`` / ``composite_tiles_jvp``
launch their kernels for CUDA tensors and take their plain versions,
``composite_tiles_plain`` / ``composite_tiles_bwd_plain`` /
``composite_tiles_jvp_plain``, for CPU tensors only.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from gslm_tpu_torch import _build
from gslm_tpu_torch.ops.composite import (clip_alpha, composite_weights,
                                          exit_state)
from gslm_tpu_torch.ops.projection import TILE, Splats2D
from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                duplicate_sort_ranges)

PIX = TILE * TILE   # pixels per tile
NF = 10             # record fields: mean2d 2, conic 3, opacity, rgb 3, invdepth
IMG_ROWS = 5        # r, g, b, invdepth, t_final
OUT_ROWS = 7        # + the exit state: log-transmittance sum, exit position


def tile_records(splats: Splats2D, ntx: int, nty: int, config: RasterConfig,
                 view_rows: int | None = None):
    """Stages 1-3 plus the record gather. Returns ``(records (n, 10) f32,
    starts (ntiles,) i32, counts (ntiles,) i32, (total_live, total_aabb))``;
    tile t composites ``records[starts[t]:starts[t] + counts[t]]`` and the
    segments cover the rows of ``records`` exactly, in tile order. The
    records are differentiable in the splats' float fields."""
    order, rank, starts, ends, totals = duplicate_sort_ranges(
        splats, ntx, nty, config.dup_capacity, view_rows=view_rows,
        cull=config.cull, live_capacity=config.live_capacity)
    table = torch.cat([splats.mean2d, splats.conic, splats.opacity[:, None],
                       splats.color, splats.invdepth[:, None]], dim=1)[order]
    records = table[rank].contiguous()
    return (records, starts.to(torch.int32), (ends - starts).to(torch.int32),
            totals)


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
                          max_elems: int | None = None):
    """Plain PyTorch version of kernel A: every tile's whole segment in
    closed form (``composite_weights``, ``exit_state``), over chunks of
    tiles of at most ``max_elems`` (record, pixel) pairs. Returns ``(tiles
    (ntiles, 7, 256), walked (ntiles,) i32)``; it walks every record of
    every segment.

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
                                          s_max, ntx, view_rows)
    return out, counts.to(torch.int32)


def _composite_chunk(records, starts, counts, tiles, S, ntx, view_rows):
    """Closed-form composite of G tiles over S record slots → (G, 7, 256);
    rows 0-4 are differentiable in ``records``, rows 5-6 (the exit state)
    are not."""
    slot = torch.arange(S, device=records.device)
    valid = slot[None] < counts[:, None]                         # (G, S)
    idx = torch.clamp(starts[:, None] + slot[None], 0, records.shape[0] - 1)
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


def composite_tiles(records: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, ntx: int, view_rows: int):
    """Composite every tile's segment → ``(tiles (ntiles, 7, 256) f32 rows
    [r, g, b, invdepth, t_final, exit lsum, exit position], walked
    (ntiles,) i32)``.

    A CUDA tensor goes through kernel A (or the call raises); a CPU tensor
    takes the plain version."""
    if records.device.type == "cpu":
        return composite_tiles_plain(records, starts, counts, ntx, view_rows)
    records, starts, counts = _check_records(records, starts, counts)
    ntiles = counts.shape[0]
    out = torch.empty(ntiles, OUT_ROWS, PIX, device=records.device)
    walked = torch.empty(ntiles, dtype=torch.int32, device=records.device)
    lib = _build.load("composite_fwd")
    rc = lib.composite_fwd(records.data_ptr(), starts.data_ptr(),
                           counts.data_ptr(), ntiles, ntx, view_rows,
                           out.data_ptr(), walked.data_ptr(),
                           torch.cuda.current_stream(records.device).cuda_stream)
    _build.check(rc, "composite_fwd")
    composite_tiles.launches += 1
    return out, walked


composite_tiles.launches = 0   # kernel A launches in this process


def composite_tiles_bwd_plain(records: torch.Tensor, starts: torch.Tensor,
                              counts: torch.Tensor, ntx: int, view_rows: int,
                              gtiles: torch.Tensor, depth_grad: bool = True,
                              max_elems: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel C: ``torch.autograd.grad`` of the
    closed-form composite (rows 0-4 of ``composite_tiles_plain``) against
    ``gtiles[:, :5]``, one chunk of tiles of at most ``max_elems`` pairs at
    a time, so memory stays bounded. Without ``depth_grad`` the invdepth
    cotangent is dropped, as kernel C drops it. Returns drec (L, 10)."""
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
                                   ntx, view_rows)
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

    A CUDA tensor goes through kernel C (or the call raises); a CPU tensor
    takes the plain version, which recomputes the forward and ignores
    ``state``."""
    if records.device.type == "cpu":
        return composite_tiles_bwd_plain(records, starts, counts, ntx,
                                         view_rows, gtiles, depth_grad)
    records, starts, counts = _check_records(records, starts, counts)
    ntiles = counts.shape[0]
    gtiles = gtiles[:, :IMG_ROWS].contiguous()
    state = state.contiguous()
    for name, t, rows in (("gtiles", gtiles, IMG_ROWS), ("state", state, 2)):
        if (t.dtype != torch.float32 or t.device != records.device
                or tuple(t.shape) != (ntiles, rows, PIX)):
            raise TypeError(f"{name} must be float32 ({ntiles}, {rows}, "
                            f"{PIX}) on {records.device}, got "
                            f"{tuple(t.shape)} {t.dtype} on {t.device}")
    drec = torch.empty_like(records)
    lib = _build.load("composite_bwd")
    rc = lib.composite_bwd(records.data_ptr(), starts.data_ptr(),
                           counts.data_ptr(), ntiles, ntx, view_rows,
                           gtiles.data_ptr(), state.data_ptr(),
                           int(depth_grad), drec.data_ptr(),
                           torch.cuda.current_stream(records.device).cuda_stream)
    _build.check(rc, "composite_bwd")
    composite_tiles_bwd.launches += 1
    return drec


composite_tiles_bwd.launches = 0   # kernel C launches in this process


def _forward_ad_level():
    """The active forward-AD level, or a new one (levels do not nest)."""
    return (contextlib.nullcontext() if fwAD._current_level >= 0
            else fwAD.dual_level())


def composite_tiles_jvp_plain(records: torch.Tensor, tangents: torch.Tensor,
                              starts: torch.Tensor, counts: torch.Tensor,
                              ntx: int, view_rows: int,
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
                                     s_max, ntx, view_rows)
                primal, tangent = fwAD.unpack_dual(o)
                out[t0:t1] = primal
                out_dot[t0:t1] = tangent[:, :IMG_ROWS]
    return out, out_dot


def composite_tiles_jvp(records: torch.Tensor, tangents: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor, ntx: int,
                        view_rows: int):
    """Composite every tile's segment and its tangent along ``tangents``
    (L, 10) → ``(tiles (ntiles, 7, 256) f32, kernel A's rows; tiles_dot
    (ntiles, 5, 256) f32 rows [r, g, b, invdepth, t_final])``.

    A CUDA tensor goes through kernel E (or the call raises); a CPU tensor
    takes the plain version."""
    if records.device.type == "cpu":
        return composite_tiles_jvp_plain(records, tangents, starts, counts,
                                         ntx, view_rows)
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
    rc = lib.composite_jvp(records.data_ptr(), tangents.data_ptr(),
                           starts.data_ptr(), counts.data_ptr(), ntiles, ntx,
                           view_rows, out.data_ptr(), out_dot.data_ptr(),
                           torch.cuda.current_stream(records.device).cuda_stream)
    _build.check(rc, "composite_jvp")
    composite_tiles_jvp.launches += 1
    return out, out_dot


composite_tiles_jvp.launches = 0   # kernel E launches in this process


def composite_image_rows(records, starts, counts, ntx: int, view_rows: int,
                         depth_grad: bool) -> torch.Tensor:
    """Rows 0-4 of every tile's composite, differentiable in ``records`` in
    either mode: reverse mode through ``Composite`` (kernels A and C),
    forward mode through kernel E when ``records`` carries a forward-AD
    tangent."""
    primal, tangent = fwAD.unpack_dual(records)
    if tangent is None:
        return Composite.apply(records, starts, counts, ntx, view_rows,
                               depth_grad)[0][:, :IMG_ROWS]
    if records.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "records carry a forward-AD tangent and record autograd: "
            "double-mode differentiation of the compositor is not supported")
    tiles, tiles_dot = composite_tiles_jvp(primal, tangent, starts, counts,
                                           ntx, view_rows)
    return fwAD.make_dual(tiles[:, :IMG_ROWS], tiles_dot)


class Composite(torch.autograd.Function):
    """Kernel A with kernel C as its VJP (the vjp branch of gslm_tpu's
    ``_make_composite``). Only rows 0-4 of the output carry gradient; the
    exit state in rows 5-6 feeds the backward."""

    @staticmethod
    def forward(ctx, records, starts, counts, ntx: int, view_rows: int,
                depth_grad: bool):
        tiles, walked = composite_tiles(records, starts, counts, ntx,
                                        view_rows)
        ctx.save_for_backward(records, starts, counts, tiles)
        ctx.geometry = (ntx, view_rows, depth_grad)
        ctx.mark_non_differentiable(walked)
        return tiles, walked

    @staticmethod
    def backward(ctx, gtiles, _):
        records, starts, counts, tiles = ctx.saved_tensors
        ntx, view_rows, depth_grad = ctx.geometry
        drec = composite_tiles_bwd(records, starts, counts, ntx, view_rows,
                                   gtiles[:, :IMG_ROWS],
                                   tiles[:, IMG_ROWS:], depth_grad)
        return drec, None, None, None, None, None


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
    records, starts, counts, (total_live, total_aabb) = tile_records(
        splats, ntx, nty, config, view_rows)
    tiles = composite_image_rows(records, starts, counts, ntx, view_rows,
                                 config.depth_grad)

    canvas = (tiles.reshape(nty, ntx, IMG_ROWS, TILE, TILE)
              .permute(2, 0, 3, 1, 4)
              .reshape(IMG_ROWS, nty * TILE, ntx * TILE)[:, :height, :width])
    rgb, invd, t_final = canvas[0:3], canvas[3:4], canvas[4:5]
    overflow = ((total_live > config.eff_capacity())
                | (total_aabb > config.dup_capacity))
    return {
        "render": rgb + t_final * bg[:, None, None],
        "invdepth": invd,
        "n_duplicates": total_live,
        "overflow": overflow.to(torch.int32),
        "max_tile_load": counts.max(),
    }
