"""Tile front-end: duplicate → sort → per-tile ranges
(stages 1-3 of gslm_tpu/ops/rasterize_tiled.py).

Each visible Gaussian owns ``tile_count`` consecutive (gaussian, tile)
entries; entries are sorted by (tile, depth rank) and every tile gets the
[start, end) range of its depth-ordered segment. The in-tile order equals
the JAX package's bit for bit: depth ascending, ties broken by original
index (one stable depth argsort at the Gaussian level, then a sort on the
unique int64 key ``tile << 32 | rank``).

Departure from the JAX package: JAX sizes every buffer to its static
capacity (``dup_capacity`` / ``live_capacity``) because XLA shapes are
static. Here the entry and record buffers are sized to the actual count, but
the capacities still truncate the stream where JAX's would (so segments,
``overflow`` and ``n_duplicates`` agree) and ``overflow`` is still reported.
The per-tile compositor itself lives in ``rasterize_cuda.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from gslm_tpu_torch import _build
from gslm_tpu_torch.ops.projection import TILE, Splats2D, quad_min_rect
from gslm_tpu_torch.struct import Struct
from gslm_tpu_torch.utils.profiling import span

IMPLS = ("auto", "cuda", "ref", "tiled", "pallas", "pallas_jvp")


@dataclasses.dataclass(frozen=True)
class RasterConfig(Struct):
    """Rasterizer capacities and switches (gslm_tpu RasterConfig).

    ``dup_capacity``: (gaussian, tile) AABB entries a render may hold.
    ``live_capacity``: entries that survive exact culling (0 → dup_capacity).
    ``cull``: exact ellipse–tile culling (drops only records the 1/255 alpha
    gate zeroes everywhere on the tile).
    ``antialiasing``: opacity rescale by the low-pass determinant ratio.
    ``impl``: "auto"/"cuda" (CUDA compositor, plain version on CPU tensors)
    or "ref" (dense golden rasterizer); "tiled", "pallas" and "pallas_jvp"
    are the JAX names of paths not ported yet and raise at render time.
    ``depth_grad``: the backward compositor (kernel C) propagates the
    invdepth image's cotangent into the splats' geometry and invdepth;
    False drops those terms (rasterize_pallas.py:572-573,628-630).
    ``bucket``: 1, 2 or 4. Above 1 stages 1-3 run on a bucket×bucket-tile
    super-grid and every tile walks its parent bucket's segment under a
    per-tile rect gate (``rasterize_cuda.tile_records``); capacities then
    count bucket records.
    ``mp_route_capacity``: 0 exchanges the model axis's projected splats
    by an all_gather; R > 0 routes each shard's records to the tile-row
    bands they meet, at most R per (source, destination) pair
    (``parallel/model_raster.py``); ``grow`` doubles it with the record
    capacities.
    ``pack``, ``chunk_rows`` and ``tile_chunk`` configure the TPU kernels
    and XLA stage 4 only and are unused by the port (the CUDA compositor
    walks whole segments).

    Every field the port does not read must keep its default: setting one
    raises instead of being silently ignored.
    """

    dup_capacity: int = 1 << 18
    tile_chunk: int = 32
    antialiasing: bool = False
    impl: str = "auto"
    pack: int = 0
    cull: bool = True
    live_capacity: int = 0
    depth_grad: bool = True
    mp_route_capacity: int = 0
    chunk_rows: int = 0
    bucket: int = 1

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl={self.impl!r}: must be one of {IMPLS}")
        if self.bucket not in (1, 2, 4):
            raise ValueError(f"bucket={self.bucket}: must be 1, 2 or 4")
        for f in UNUSED_FIELDS:
            if getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"{f.name}={getattr(self, f.name)!r}: the port does not "
                    f"read it yet; leave it at {f.default!r}")

    def eff_capacity(self) -> int:
        return (self.live_capacity or self.dup_capacity) if self.cull \
            else self.dup_capacity

    def grow(self, factor: int = 2) -> "RasterConfig":
        """Overflow recovery: every capacity ceiling grows by ``factor``
        (the post-cull live ceiling too, or the overflow persists)."""
        return self.replace(dup_capacity=factor * self.dup_capacity,
                            live_capacity=factor * self.live_capacity,
                            mp_route_capacity=factor * self.mp_route_capacity)


UNUSED_FIELDS = tuple(
    f for f in dataclasses.fields(RasterConfig)
    if f.name in ("tile_chunk", "pack", "chunk_rows"))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _lower_bound(keys: torch.Tensor, bounds: torch.Tensor, n: int):
    """For each bound, the count of (ascending) ``keys[:n]`` strictly below
    it."""
    return torch.searchsorted(keys[:n].contiguous(), bounds, right=False)


def bucket_splats(splats: Splats2D, bucket: int) -> Splats2D:
    """The splats with their tile rects coarsened to bucket×bucket-tile
    units (floor of the min corner, ceiling of the max corner) and
    ``tile_count`` the buckets each visible splat touches."""
    bx0 = torch.div(splats.rect_min[:, 0], bucket, rounding_mode="floor")
    by0 = torch.div(splats.rect_min[:, 1], bucket, rounding_mode="floor")
    bx1 = -torch.div(-splats.rect_max[:, 0], bucket, rounding_mode="floor")
    by1 = -torch.div(-splats.rect_max[:, 1], bucket, rounding_mode="floor")
    count = torch.where(splats.tile_count > 0, (bx1 - bx0) * (by1 - by0), 0)
    return splats.replace(rect_min=torch.stack([bx0, by0], dim=-1),
                          rect_max=torch.stack([bx1, by1], dim=-1),
                          tile_count=count.to(splats.tile_count.dtype))


def _cell_masks_plain(splats: Splats2D, view_rows: int, cwb: int,
                      tile_px: int = TILE):
    """Per-Gaussian 8×8-cell survival masks for exact ellipse–tile culling.

    Each rect is cut into an 8×8 grid of cells of cw×ch whole grid units
    (cw = ceil(w/8)); a unit is ``tile_px`` pixels wide (TILE for tiles,
    TILE * bucket for bucket rects). A cell survives iff the exact minimum
    of the conic quadratic over its pixel rectangle lies within the alpha
    >= 1/255 level set. Returns the three packed int32 mask words
    (22/22/20 bits), the packed cell size ``(ch << cwb) | cw`` and the
    surviving-tile count."""
    x0r, y0r = splats.rect_min[:, 0], splats.rect_min[:, 1]
    x1r, y1r = splats.rect_max[:, 0], splats.rect_max[:, 1]
    wr = torch.clamp(x1r - x0r, min=1)
    hr = torch.clamp(y1r - y0r, min=1)
    cw = (wr + 7) >> 3
    ch = (hr + 7) >> 3
    # tile rows are view-local in pixel space (stacked multi-view batches)
    y0loc = torch.remainder(y0r, view_rows)
    mx, my = splats.mean2d[:, 0], splats.mean2d[:, 1]
    qa = torch.clamp(splats.conic[:, 0], min=1e-12)
    qb = splats.conic[:, 1]
    qc = torch.clamp(splats.conic[:, 2], min=1e-12)
    s2 = 2.0 * torch.log(torch.clamp(splats.opacity * 255.0, min=1e-12))
    ftile = float(tile_px)
    words = [torch.zeros_like(x0r) for _ in range(3)]
    nlive = torch.zeros_like(x0r)
    for b in range(64):
        cy_, cx_ = b >> 3, b & 7
        ax0 = cx_ * cw
        ax1 = torch.minimum(ax0 + cw, wr)
        ay0 = cy_ * ch
        ay1 = torch.minimum(ay0 + ch, hr)
        nx = torch.clamp(ax1 - ax0, min=0)
        ny = torch.clamp(ay1 - ay0, min=0)
        qmin = quad_min_rect(
            qa, qb, qc,
            (x0r + ax0).float() * ftile - mx,
            (x0r + ax1).float() * ftile - 1.0 - mx,
            (y0loc + ay0).float() * ftile - my,
            (y0loc + ay1).float() * ftile - 1.0 - my)
        keep = (nx > 0) & (ny > 0) & (qmin * (1.0 - 1e-4) <= s2 + 1e-3)
        wi, sh = (0, b) if b < 22 else ((1, b - 22) if b < 44 else (2, b - 44))
        words[wi] = words[wi] | (keep.to(torch.int32) << sh)
        nlive = nlive + torch.where(keep, nx * ny, 0)
    nlive = torch.where(splats.tile_count > 0, nlive, 0)
    return words[0], words[1], words[2], (ch << cwb) | cw, nlive


def _cell_masks(splats: Splats2D, view_rows: int, cwb: int,
                tile_px: int = TILE):
    """``_cell_masks_plain``'s five int32 outputs. CUDA tensors go through
    kernel G (csrc/cell_masks.cu), one launch, bit for bit the plain
    version's (or the call raises); CPU tensors take the plain version.
    The kernel reads primals only: forward-AD duals are detached, the
    outputs being integers."""
    dev = splats.mean2d.device
    if dev.type == "cpu":
        return _cell_masks_plain(splats, view_rows, cwb, tile_px)
    if dev.type != "cuda":
        raise TypeError(f"_cell_masks takes CPU or CUDA tensors, got {dev}")
    P = splats.mean2d.shape[0]
    # contiguous: a no-op on the main path; the model axis's packed rows
    # are copied (held until the launch, so no copy is freed early)
    mean2d, conic, opacity = (t.detach().contiguous() for t in (
        splats.mean2d, splats.conic, splats.opacity))
    rect_min, rect_max, tile_count = (t.detach().contiguous() for t in (
        splats.rect_min, splats.rect_max, splats.tile_count))
    if (any(t.dtype != torch.float32 or t.device != dev
            for t in (mean2d, conic, opacity))
            or any(t.dtype != torch.int32 or t.device != dev
                   for t in (rect_min, rect_max, tile_count))
            or tuple(mean2d.shape) != (P, 2) or tuple(conic.shape) != (P, 3)
            or tuple(opacity.shape) != (P,)
            or tuple(rect_min.shape) != (P, 2)
            or tuple(rect_max.shape) != (P, 2)
            or tuple(tile_count.shape) != (P,)):
        raise TypeError(f"_cell_masks needs float32 mean2d (P, 2), conic "
                        f"(P, 3) and opacity (P,), int32 rect_min and "
                        f"rect_max (P, 2) and tile_count (P,), all on {dev}")
    # five allocations, freed one by one as the plain version's are
    out = tuple(torch.empty(P, dtype=torch.int32, device=dev)
                for _ in range(5))
    if P:
        rc = _build.load("cell_masks").cell_masks(
            rect_min.data_ptr(), rect_max.data_ptr(), mean2d.data_ptr(),
            conic.data_ptr(), opacity.data_ptr(), tile_count.data_ptr(), P,
            view_rows, cwb, tile_px, *(t.data_ptr() for t in out),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "cell_masks")
        _cell_masks.launches += 1
    return out


_cell_masks.launches = 0   # kernel G launches in this process


@torch.no_grad()
def duplicate_sort_ranges(splats: Splats2D, ntx: int, nty: int, L: int, *,
                          view_rows: int | None = None, cull: bool = False,
                          live_capacity: int = 0, tile_px: int = TILE):
    """Stages 1-3 of the tile pipeline (``tile_px``: the pixel size of one
    grid unit, as in ``_cell_masks``).

    Returns ``(order (P,), rank (n,), starts (ntiles,), ends (ntiles,),
    (total_live, total_aabb))``: ``order`` is the stable depth-ascending
    permutation of Gaussians; ``rank[i]`` indexes the depth-sorted
    per-Gaussian tables (``field[order][rank]``); tile t's entries are
    ``rank[starts[t]:ends[t]]``. Without overflow the segments are exactly
    the JAX package's; ``n = ends[-1]``, the entries kept (JAX pads ``rank``
    to its static capacity instead). Every output is an index: the stages
    run without autograd."""
    ntiles = ntx * nty
    P = splats.mean2d.shape[0]
    dev = splats.mean2d.device
    if view_rows is None:
        view_rows = nty
    Leff = (live_capacity or L) if cull else L

    with span("gslm.front_end.duplicate"):
        # ---- 1. depth pre-sort at P level (stable; invisible last) -------
        depth_key = torch.where(splats.visible, splats.depth, torch.inf)
        order = torch.argsort(depth_key, stable=True)
        counts = splats.tile_count[order].long()
        x0 = splats.rect_min[order, 0].long()
        x1 = splats.rect_max[order, 0].long()
        y0 = splats.rect_min[order, 1].long()
        offsets = torch.cumsum(counts, 0) - counts
        total = counts.sum()

        # ---- 2. duplicate: entry e of depth rank g covers one tile of g's
        # rect; JAX keeps only the first L entries (its static capacity)
        rank_e = torch.repeat_interleave(
            torch.arange(P, device=dev), counts)[:L]
        r = torch.arange(rank_e.shape[0], device=dev) - offsets[rank_e]
        w_e = torch.clamp(x1 - x0, min=1)[rank_e]
        dy = torch.div(r, w_e, rounding_mode="floor")
        dx = r - dy * w_e
        tile = (y0 * ntx + x0)[rank_e] + dy * ntx + dx

    if cull:
        cwb = max(_cdiv(ntx, 8).bit_length(), 1)
        with span("gslm.front_end.cell_masks"):
            m0, m1, m2, cwch, nlive = _cell_masks(splats, view_rows, cwb,
                                                  tile_px)
        with span("gslm.front_end.duplicate"):
            total_live = nlive.sum()
            m0, m1, m2, cwch = (v[order].long()[rank_e]
                                for v in (m0, m1, m2, cwch))
            cw_e = torch.clamp(cwch & ((1 << cwb) - 1), min=1)
            ch_e = torch.clamp(cwch >> cwb, min=1)
            cb = (torch.clamp(torch.div(dy, ch_e, rounding_mode="floor"),
                              0, 7) * 8
                  + torch.clamp(torch.div(dx, cw_e, rounding_mode="floor"),
                                0, 7))
            word = torch.where(cb < 22, m0, torch.where(cb < 44, m1, m2))
            shv = torch.where(cb < 22, cb,
                              torch.where(cb < 44, cb - 22, cb - 44))
            live = ((word >> shv) & 1) > 0
            tile, rank_e = tile[live], rank_e[live]
    else:
        total_live = total

    # ---- 3. sort on the unique (tile, rank) key; ranges by binary search
    with span("gslm.front_end.sort"):
        key, _ = torch.sort((tile << 32) | rank_e)
        key = key[:Leff]
        rank = key & 0xFFFFFFFF
        bounds = (torch.arange(ntiles, device=dev) + 1) << 32
        ends = _lower_bound(key, bounds, Leff)
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    return order, rank, starts, ends, (total_live, total)
