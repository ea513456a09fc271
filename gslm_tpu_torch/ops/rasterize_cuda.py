"""Forward tile rasterizer around kernel A (csrc/composite_fwd.cu).

Counterpart of the forward half of ``rasterize_pallas``
(gslm_tpu/ops/rasterize_pallas.py, bucket = 1): stages 1-3 of the tile
pipeline (``duplicate_sort_ranges``), the depth-sorted record table
gathered with plain indexing (JAX also gathers outside its kernel), the
per-tile (start, count) segment table, the compositor, then canvas assembly
and the background blend ``render = rgb + t_final * bg``.

``composite_tiles`` launches kernel A for CUDA tensors and takes its plain
version, ``composite_tiles_plain``, for CPU tensors only.
"""

from __future__ import annotations

import numpy as np
import torch

from gslm_tpu_torch import _build
from gslm_tpu_torch.ops.composite import clip_alpha, composite_weights
from gslm_tpu_torch.ops.projection import TILE, Splats2D
from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                duplicate_sort_ranges)

PIX = TILE * TILE   # pixels per tile
NF = 10             # record fields: mean2d 2, conic 3, opacity, rgb 3, invdepth
OUT_ROWS = 5        # r, g, b, invdepth, t_final


def tile_records(splats: Splats2D, ntx: int, nty: int, config: RasterConfig,
                 view_rows: int | None = None):
    """Stages 1-3 plus the record gather. Returns ``(records (n, 10) f32,
    starts (ntiles,) i32, counts (ntiles,) i32, (total_live, total_aabb))``;
    tile t composites ``records[starts[t]:starts[t] + counts[t]]``."""
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


def composite_tiles_plain(records: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, ntx: int, view_rows: int,
                          max_elems: int | None = None):
    """Plain PyTorch version of kernel A: every tile's whole segment in
    closed form (``composite_weights``), over chunks of tiles of at most
    ``max_elems`` (record, pixel) pairs. Returns ``(tiles (ntiles, 5, 256),
    walked (ntiles,) i32)``; it walks every record of every segment.

    Sums over records run as sequential cumsums, so a tile's result does
    not depend on which tiles share its chunk (a batched render equals the
    single-view render bit for bit on the CPU)."""
    dev = records.device
    ntiles = counts.shape[0]
    if max_elems is None:
        max_elems = 1 << 25 if dev.type == "cuda" else 1 << 22
    out = torch.zeros(ntiles, OUT_ROWS, PIX, device=dev)
    out[:, 4] = 1.0
    cnt = counts.cpu().numpy().astype(np.int64)
    t0 = 0
    while t0 < ntiles:
        t1, s_max = t0, 0
        while t1 < ntiles:
            s_new = max(s_max, int(cnt[t1]))
            if t1 > t0 and (t1 - t0 + 1) * s_new * PIX > max_elems:
                break
            s_max, t1 = s_new, t1 + 1
        if s_max > 0:
            out[t0:t1] = _composite_chunk(records, starts[t0:t1].long(),
                                          counts[t0:t1].long(),
                                          torch.arange(t0, t1, device=dev),
                                          s_max, ntx, view_rows)
        t0 = t1
    return out, counts.to(torch.int32)


def _composite_chunk(records, starts, counts, tiles, S, ntx, view_rows):
    """Closed-form composite of G tiles over S record slots → (G, 5, 256)."""
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
    alpha = clip_alpha(rec[..., 5, None] * torch.exp(power))
    weights, t_final = composite_weights(alpha.transpose(0, 1))  # (S, G, 256)
    feat = rec[..., 6:10].transpose(0, 1)                        # (S, G, 4)
    acc = torch.cumsum(weights[..., None] * feat[:, :, None], dim=0)[-1]
    return torch.cat([acc.permute(0, 2, 1), t_final[:, None]], dim=1)


def composite_tiles(records: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, ntx: int, view_rows: int):
    """Composite every tile's segment → ``(tiles (ntiles, 5, 256) f32 rows
    [r, g, b, invdepth, t_final], walked (ntiles,) i32)``.

    A CUDA tensor goes through kernel A (or the call raises); a CPU tensor
    takes the plain version."""
    if records.device.type == "cpu":
        return composite_tiles_plain(records, starts, counts, ntx, view_rows)
    if (records.device.type != "cuda" or records.dtype != torch.float32
            or records.ndim != 2 or records.shape[1] != NF):
        raise TypeError(f"records must be CUDA float32 (L, {NF}), got "
                        f"{tuple(records.shape)} {records.dtype} on "
                        f"{records.device}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or t.device != records.device:
            raise TypeError(f"{name} must be int32 on {records.device}")
    records, starts, counts = (records.contiguous(), starts.contiguous(),
                               counts.contiguous())
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


def rasterize_cuda(splats: Splats2D, height: int, width: int,
                   bg: torch.Tensor, config: RasterConfig,
                   view_rows: int | None = None) -> dict:
    """Composite splats over a (height, width) canvas.

    Returns dict(render (3,H,W), invdepth (1,H,W), n_duplicates, overflow,
    max_tile_load). ``view_rows``: tile rows per view of a stacked
    multi-view canvas (splat coordinates are view-local)."""
    ntx, nty = _cdiv(width, TILE), _cdiv(height, TILE)
    if view_rows is None:
        view_rows = nty
    records, starts, counts, (total_live, total_aabb) = tile_records(
        splats, ntx, nty, config, view_rows)
    tiles, _ = composite_tiles(records, starts, counts, ntx, view_rows)

    canvas = (tiles.reshape(nty, ntx, OUT_ROWS, TILE, TILE)
              .permute(2, 0, 3, 1, 4)
              .reshape(OUT_ROWS, nty * TILE, ntx * TILE)[:, :height, :width])
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
