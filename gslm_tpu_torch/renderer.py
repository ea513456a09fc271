"""High-level render API (gslm_tpu/renderer.py): ``render`` one view,
``batch_render`` a camera batch as one raster problem.

Both entry points are differentiable in every parameter group (kernel C,
or kernel D with bucket binning, is the compositor's VJP); serving callers
wrap them in ``torch.no_grad()``. ``config.bucket`` > 1 needs the view's
tile rows divisible by it, or they raise ``ValueError``.
``alive=None`` masks with ``params.alive`` (the JAX package takes the mask
as an argument; dead slots are transparent either way).
"""

from __future__ import annotations

import dataclasses

import torch

from gslm_tpu_torch.models.cameras import Camera, CameraBatch
from gslm_tpu_torch.models.gaussians import GaussianParams
from gslm_tpu_torch.ops.projection import TILE, Splats2D, preprocess
from gslm_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from gslm_tpu_torch.ops.rasterize_ref import rasterize_ref
from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                _cell_masks, bucket_splats)
from gslm_tpu_torch.struct import Struct
from gslm_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class RenderOutput(Struct):
    render: torch.Tensor         # (3, H, W) in [0, 1]; (B, 3, H, W) batched
    invdepth: torch.Tensor       # (1, H, W)
    radii: torch.Tensor          # (P,) int32; (B, P) batched
    visibility: torch.Tensor     # (P,) bool
    n_duplicates: torch.Tensor   # () diagnostics
    overflow: torch.Tensor       # () int32
    max_tile_load: torch.Tensor  # ()


def resolve_impl(impl: str) -> str:
    """"auto"/"cuda" → the CUDA compositor path, "ref" → dense golden; the
    JAX names of paths not ported yet raise."""
    if impl in ("auto", "cuda"):
        return "cuda"
    if impl == "ref":
        return "ref"
    raise NotImplementedError(
        f"impl={impl!r} is not ported to gslm_tpu_torch yet; use 'auto', "
        "'cuda' or 'ref'")


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """image (..., 3, H, W), exposure (..., 3, 4) affine:
    out_d = Σ_c img_c E[c,d] + E[d,3]. Written as elementwise terms so a
    batched and a single-view render agree bit for bit."""
    m = exposure[..., :3, :3, None, None]                # (..., 3, 3, 1, 1)
    out = (image[..., 0:1, :, :] * m[..., 0, :, :, :]
           + image[..., 1:2, :, :] * m[..., 1, :, :, :]
           + image[..., 2:3, :, :] * m[..., 2, :, :, :])
    return out + exposure[..., :3, 3, None, None]


def _check_bucket(config: RasterConfig, height: int) -> int:
    """The view's tile rows; bucket binning needs them divisible by
    ``config.bucket`` (bucket rows must not straddle stacked views)."""
    nty = _cdiv(height, TILE)
    if nty % config.bucket:
        raise ValueError(f"bucket={config.bucket} needs the view's tile rows "
                         f"({nty}) divisible by it")
    return nty


def _pre(params, camera, config, active_sh_degree, scaling_modifier, alive,
         mean2d_offset):
    with span("gslm.preprocess"):
        return preprocess(params, camera, active_sh_degree=active_sh_degree,
                          antialiasing=config.antialiasing,
                          scaling_modifier=scaling_modifier,
                          alive=params.alive if alive is None else alive,
                          mean2d_offset=mean2d_offset)


def _output(image, invdepth, radii, out) -> RenderOutput:
    return RenderOutput(
        render=torch.clamp(image, 0.0, 1.0), invdepth=invdepth, radii=radii,
        visibility=radii > 0, n_duplicates=torch.as_tensor(out["n_duplicates"]),
        overflow=torch.as_tensor(out["overflow"]).to(torch.int32),
        max_tile_load=torch.as_tensor(out["max_tile_load"]))


def render(params: GaussianParams, camera: Camera, bg: torch.Tensor, *,
           config: RasterConfig = RasterConfig(),
           active_sh_degree: int | None = None,
           scaling_modifier: float = 1.0,
           use_trained_exp: bool = False,
           alive: torch.Tensor | None = None,
           mean2d_offset: torch.Tensor | None = None,
           impl: str | None = None) -> RenderOutput:
    """Render one view. ``impl`` (default ``config.impl``): "auto"/"cuda"
    (kernels A and C on CUDA tensors, their plain versions on CPU tensors)
    or "ref". ``mean2d_offset``: (P, 2) gradient carrier of the
    densification statistics (``preprocess``)."""
    with span("gslm.render"):
        impl = resolve_impl(config.impl if impl is None else impl)
        if impl == "cuda":
            _check_bucket(config, camera.height)
        if active_sh_degree is None:
            active_sh_degree = params.sh_degree
        splats = _pre(params, camera, config, active_sh_degree,
                      scaling_modifier, alive, mean2d_offset)
        if impl == "ref":
            out = rasterize_ref(splats, camera.height, camera.width, bg)
            zero = torch.zeros((), dtype=torch.int64, device=bg.device)
            out.update(n_duplicates=zero, overflow=zero, max_tile_load=zero)
        else:
            out = rasterize_cuda(splats, camera.height, camera.width, bg,
                                 config)
        image = out["render"]
        if use_trained_exp:
            image = apply_exposure(image,
                                   params.exposure[camera.exposure_idx])
        return _output(image, out["invdepth"], splats.radius, out)


def stack_views(params: GaussianParams, cameras: CameraBatch, *,
                config: RasterConfig = RasterConfig(),
                active_sh_degree: int | None = None,
                scaling_modifier: float = 1.0,
                alive: torch.Tensor | None = None,
                mean2d_offset: torch.Tensor | None = None):
    """Preprocess every view and stack the B per-view tile grids vertically
    into one canvas: view v's tile rows are offset by v*nty, its splat
    coordinates stay view-local (the compositor wraps tile rows modulo
    nty). Returns ``(splats (B*P, ...), per-view radii (B, P), nty)``.

    The views are preprocessed one at a time, each exactly as ``render``
    does it, so the stacked records are bit for bit the single-view ones."""
    if active_sh_degree is None:
        active_sh_degree = params.sh_degree
    nty = _cdiv(cameras.height, TILE)
    views = [_pre(params, cameras.view(i), config, active_sh_degree,
                  scaling_modifier, alive, mean2d_offset)
             for i in range(cameras.batch_size)]
    fields = {f.name: torch.cat([getattr(s, f.name) for s in views])
              for f in dataclasses.fields(Splats2D)}
    P = params.capacity
    voff = torch.arange(len(views), dtype=torch.int32,
                        device=params.xyz.device).repeat_interleave(P) * nty
    for k in ("rect_min", "rect_max"):
        r = fields[k].clone()
        r[:, 1] += voff
        fields[k] = r
    radii = torch.stack([s.radius for s in views])
    return Splats2D(**fields), radii, nty


def batch_render(params: GaussianParams, cameras: CameraBatch,
                 bg: torch.Tensor, *, config: RasterConfig = RasterConfig(),
                 active_sh_degree: int | None = None,
                 scaling_modifier: float = 1.0,
                 use_trained_exp: bool = False,
                 alive: torch.Tensor | None = None,
                 mean2d_offset: torch.Tensor | None = None,
                 impl: str | None = None) -> RenderOutput:
    """Render a padded camera batch as ONE raster problem: one
    duplicate/sort/ranges pass and one compositor launch cover all views
    (``stack_views``). Within each tile the global depth order restricted to
    that view's Gaussians is the view's own depth order, so view v of the
    batch equals ``render`` of view v. Output fields gain a leading B
    axis.

    ``mean2d_offset`` is unbatched ((P, 2)): it broadcasts over views, so
    its cotangent sums over them, the accumulated screen-space gradient
    that densification reads."""
    with span("gslm.render"):
        impl = resolve_impl(config.impl if impl is None else impl)
        if impl == "ref":
            outs = [render(params, cameras.view(i), bg, config=config,
                           active_sh_degree=active_sh_degree,
                           scaling_modifier=scaling_modifier,
                           use_trained_exp=use_trained_exp, alive=alive,
                           mean2d_offset=mean2d_offset, impl=impl)
                    for i in range(cameras.batch_size)]
            return RenderOutput(**{f.name: torch.stack([getattr(o, f.name)
                                                        for o in outs])
                                   for f in dataclasses.fields(RenderOutput)})

        H, W = cameras.height, cameras.width
        B = cameras.batch_size
        _check_bucket(config, H)
        splats, radii, nty = stack_views(
            params, cameras, config=config,
            active_sh_degree=active_sh_degree,
            scaling_modifier=scaling_modifier, alive=alive,
            mean2d_offset=mean2d_offset)
        out = rasterize_cuda(splats, B * nty * TILE, W, bg, config,
                             view_rows=nty)
        rows = nty * TILE
        image = out["render"].reshape(3, B, rows, W)[:, :, :H].transpose(0, 1)
        invd = out["invdepth"].reshape(1, B, rows, W)[:, :, :H].transpose(0, 1)
        if use_trained_exp:
            image = apply_exposure(image,
                                   params.exposure[cameras.exposure_idx])
        return _output(image, invd, radii, out)


def band_counts(splats: Splats2D, n_views: int, height: int, n_model: int,
                src_blocks: int | None = None):
    """The model axis's record counts of ``stack_views``' splats (view v's
    tile rows offset by v·nty): ``(band (B, M), routed (B, S, M))``, band d
    the AABB records of its tile-row band (``model_raster.band_rows``) and
    ``routed[:, s, d]`` how many splats of source block s the routed
    exchange sends to band d: the rows split into S = ``src_blocks``
    contiguous blocks, default M (the whole capacity's shards); a shard's
    own rows are one block."""
    from gslm_tpu_torch.parallel.model_raster import band_rows
    nty = _cdiv(height, TILE)
    bh = band_rows(height, n_model)
    S = n_model if src_blocks is None else src_blocks
    P = splats.mean2d.shape[0] // n_views
    voff = torch.arange(n_views, dtype=torch.int32,
                        device=splats.mean2d.device).repeat_interleave(P) \
        * nty
    y0 = splats.rect_min[:, 1] - voff
    y1 = splats.rect_max[:, 1] - voff
    w = torch.clamp(splats.rect_max[:, 0] - splats.rect_min[:, 0], min=0)
    vis = splats.tile_count > 0
    band, routed = [], []
    for d in range(n_model):
        rows = (torch.clamp(y1, d * bh, (d + 1) * bh)
                - torch.clamp(y0, d * bh, (d + 1) * bh))
        band.append(torch.where(vis, w * rows, 0).reshape(n_views, P)
                    .sum(dim=1))
        routed.append((vis & (rows > 0)).reshape(n_views, S, P // S)
                      .sum(dim=2))
    return torch.stack(band, dim=1), torch.stack(routed, dim=2)


@torch.no_grad()
def overflow_probe(params: GaussianParams, cameras: CameraBatch, *,
                   config: RasterConfig = RasterConfig(),
                   active_sh_degree: int | None = None,
                   alive: torch.Tensor | None = None,
                   per_view: bool = False, n_model: int = 1) -> dict:
    """Would rendering this camera batch overflow ``config``'s record
    capacities? Runs the per-Gaussian preprocess of every view and, with
    culling, the cull cell masks (all views in one pass over the stacked
    splats); no duplication, sort or compositing. With ``config.bucket`` >
    1 the counts are bucket records, as the bucket-binned raster counts
    them (rects coarsened to buckets, cull cells of bucket pixels).

    ``per_view=False``: dict(n_aabb, n_live, overflow) summed over the
    views, overflow as the rasterizer flags it (live total over the
    effective capacity, or AABB total over ``dup_capacity``).
    ``per_view=True``: (B,) ``n_aabb`` and ``n_live``; capacities bound ONE
    render, so a caller that renders in micro-batch chunks compares
    per-chunk sums. With ``n_model`` > 1 it adds the model axis's counts
    of the whole parameter set (``band_counts``): ``band_aabb`` (B, M), the
    AABB records of each tile-row band, and with ``config.mp_route_capacity``
    > 0 ``route_counts`` (B, M_src, M_dst), the routed records per source
    shard's rows and destination band."""
    B, P = cameras.batch_size, params.capacity
    bk = config.bucket
    nty = _check_bucket(config, cameras.height)
    splats = stack_views(params, cameras, config=config,
                         active_sh_degree=active_sh_degree, alive=alive)[0]
    model = {}
    if n_model > 1:
        band, routed = band_counts(splats, B, cameras.height, n_model)
        model["band_aabb"] = band
        if config.mp_route_capacity > 0:
            model["route_counts"] = routed
    if bk > 1:
        splats = bucket_splats(splats, bk)
    n_aabb = splats.tile_count.reshape(B, P).sum(dim=1)
    if config.cull:
        cwb = max(_cdiv(_cdiv(_cdiv(cameras.width, TILE), bk), 8)
                  .bit_length(), 1)
        nlive = _cell_masks(splats, nty // bk, cwb, TILE * bk)[-1]
        n_live = nlive.reshape(B, P).sum(dim=1)
    else:
        n_live = n_aabb
    if per_view:
        return {"n_aabb": n_aabb, "n_live": n_live} | model
    n_aabb, n_live = n_aabb.sum(), n_live.sum()
    over = ((n_live > config.eff_capacity())
            | (n_aabb > config.dup_capacity)).to(torch.int32)
    return {"n_aabb": n_aabb, "n_live": n_live, "overflow": over}
