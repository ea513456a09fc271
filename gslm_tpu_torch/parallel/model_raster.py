"""The model axis's raster path (gslm_tpu/parallel/model_raster.py):
Gaussians sharded over ranks, tile rows banded.

Each rank of a model group holds its contiguous block of Pl = C/M Gaussian
rows (``parallel.shard_state``) and owns a horizontal band of tile rows of
every view, rows ``[m·bh, (m+1)·bh)`` with ``bh = band_rows(H, M)``:

1. it preprocesses its own rows for its views (the data axis's block);
2. it exchanges the projected splats over the model group, one of two
   ways (``RasterConfig.mp_route_capacity``):

   - ``0``: an all_gather of every rank's splats (``parallel.comm``), in
     rank order, which is the single process's row order;
   - ``R > 0``: each rank compacts, per destination band, the splats whose
     tile rect meets that band into an (M, R) row block and ships them in
     one all_to_all; a count above R raises the overflow flag, records
     are never dropped silently;

3. it clips the rects to its band, shifts ``mean2d`` by ``band_lo·16``
   (exact in float32) and composites the ``Bd`` bands stacked into one
   canvas of ``Bd·bh·16`` rows through ``rasterize_cuda(view_rows=bh)``:
   kernel A forward, kernel C backward, kernel E in forward mode.

Gradients come back to the owner rows through the exchange's transpose.
The SSIM windows cross band edges through a 5-row halo
(``halo_exchange_rows``, built from an all_gather of every band's top and
bottom rows), and densification runs per shard, ``mp_rebalance`` moving
rows from full shards to free ones.

The functions take the ``parallel.Mesh`` where JAX takes axis names; every
rank of a model group must call them together. The routed records arrive
shard-major, so splats of equal depth may swap against the single process
(the knife edge JAX documents at :28-31).
"""

from __future__ import annotations

import torch

from gslm_tpu_torch.models.cameras import CameraBatch
from gslm_tpu_torch.ops.projection import TILE, Splats2D
from gslm_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig, _cdiv
from gslm_tpu_torch.parallel.comm import all_gather, all_to_all
from gslm_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce

HALO = 5                      # the SSIM window's radius (11 // 2)
_LOGGED: set = set()

# the exchanged splat row: float fields (differentiable), then int fields
_FLOATS = 11                  # mean2d 2, conic 3, color 3, opacity, depth,
                              # invdepth
_INTS = 7                     # radius, rect_min 2, rect_max 2, tile_count,
                              # visible


def band_rows(height: int, n_model: int) -> int:
    """Tile rows per model shard."""
    return _cdiv(_cdiv(height, TILE), n_model)


def exchange_bytes(Bd: int, Pl: int, n_model: int,
                   route_capacity: int) -> int:
    """Per-rank splat-exchange bytes of the two strategies: the all_gather
    ships Bd·M·Pl splat rows (11 float32 and 7 int32 fields), routing
    M·R records (11 float32 fields, the rect, the view and a valid flag)."""
    splat_row = (2 + 3 + 3 + 1 + 1 + 1) * 4 + (1 + 2 + 2 + 1 + 1) * 4
    record_row = (2 + 3 + 3 + 1 + 1 + 1) * 4 + 4 * 4 + 4 + 4
    if route_capacity > 0:
        return n_model * route_capacity * record_row
    return Bd * n_model * Pl * splat_row


def band_slice(x: torch.Tensor, height: int, mesh: Mesh,
               fill: float = 0.0) -> torch.Tensor:
    """This rank's tile-row band of per-view images (..., H, W) → (...,
    band_rows·16, W), padded with ``fill`` past H."""
    bh_px = band_rows(height, mesh.n_model) * TILE
    pad = mesh.n_model * bh_px - height
    if pad:
        x = torch.cat([x, x.new_full(x.shape[:-2] + (pad, x.shape[-1]),
                                     fill)], dim=-2)
    lo = mesh.model_rank * bh_px
    return x[..., lo:lo + bh_px, :]


def _rows_in_canvas(height: int, mesh: Mesh, device) -> torch.Tensor:
    """(band_rows·16, 1) float: 1 on this band's rows that lie above H."""
    bh_px = band_rows(height, mesh.n_model) * TILE
    rows = mesh.model_rank * bh_px + torch.arange(bh_px, device=device)
    return (rows < height).to(torch.float32)[:, None]


def _pack(views: list[Splats2D]) -> tuple[torch.Tensor, torch.Tensor]:
    """The views' splats as (Bd, Pl, 11) float32 and (Bd, Pl, 7) int32."""
    fl = torch.stack([torch.cat(
        [s.mean2d, s.conic, s.color, s.opacity[:, None], s.depth[:, None],
         s.invdepth[:, None]], dim=1) for s in views])
    it = torch.stack([torch.cat(
        [s.radius[:, None], s.rect_min, s.rect_max, s.tile_count[:, None],
         s.visible[:, None].to(torch.int32)], dim=1) for s in views])
    return fl, it


def _band_splats(fl, x0, y0r, x1, y1r, visible, view, bh: int,
                 band_lo: int, radius=None) -> Splats2D:
    """Flat splats clipped to the band [band_lo, band_lo + bh) and shifted
    to band-local coordinates, each view's band stacked at rows
    ``view·bh``."""
    y0 = torch.clamp(y0r, band_lo, band_lo + bh) - band_lo
    y1 = torch.clamp(y1r, band_lo, band_lo + bh) - band_lo
    tc = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    vis = visible & (tc > 0)
    mean2d = torch.stack([fl[:, 0], fl[:, 1] - float(band_lo * TILE)], -1)
    return Splats2D(
        mean2d=mean2d, conic=fl[:, 2:5], color=fl[:, 5:8],
        opacity=torch.where(vis, fl[:, 8], 0.0),
        depth=torch.where(vis, fl[:, 9], torch.inf), invdepth=fl[:, 10],
        radius=torch.zeros_like(tc) if radius is None else radius,
        rect_min=torch.stack([x0, y0 + view * bh], -1),
        rect_max=torch.stack([x1, y1 + view * bh], -1),
        tile_count=torch.where(vis, tc, 0), visible=vis)


def _gather_band_splats(views, bh: int, mesh: Mesh, band_lo: int
                        ) -> Splats2D:
    """The all_gather exchange (``mp_route_capacity`` 0)."""
    fl, it = _pack(views)
    fl = all_gather(fl, mesh.model_group, dim=1)          # (Bd, P, 11)
    it = all_gather(it, mesh.model_group, dim=1)          # (Bd, P, 7)
    Bd, P = fl.shape[:2]
    view = torch.arange(Bd, dtype=torch.int32,
                        device=fl.device).repeat_interleave(P)
    fl, it = fl.reshape(Bd * P, _FLOATS), it.reshape(Bd * P, _INTS)
    return _band_splats(fl, it[:, 1], it[:, 2], it[:, 3], it[:, 4],
                        it[:, 6] > 0, view, bh, band_lo, radius=it[:, 0])


def _route_indices(y0, y1, vis, R: int, bh: int, n_model: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per destination band d, the flat indices of the local splats whose
    tile rows [y0, y1) meet band d, compacted in index order into R slots
    (-1: empty): ``(idx (M, R) int64, counts (M,) int64)``. A count above
    R loses the records past R: the caller raises the overflow flag."""
    N = vis.shape[0]
    iota = torch.arange(N, device=vis.device)
    idx = torch.full((n_model, R), -1, dtype=torch.long, device=vis.device)
    counts = []
    for d in range(n_model):
        m_d = vis & (y1 > d * bh) & (y0 < (d + 1) * bh)
        pos = torch.cumsum(m_d.to(torch.long), 0) - 1
        keep = m_d & (pos < R)
        idx[d, pos[keep]] = iota[keep]
        counts.append(m_d.sum())
    return idx, torch.stack(counts)


def _route_band_splats(views, R: int, bh: int, mesh: Mesh, band_lo: int):
    """The routed exchange (``mp_route_capacity`` R > 0): each local
    (view, splat) record goes only to the bands its tile rect meets, in one
    all_to_all of (M, R) blocks; empty rows carry opacity 0 and depth inf.
    Returns (band-local flat Splats2D of M·R rows, overflow flag: this
    sender's largest count above R)."""
    M = mesh.n_model
    fl, it = _pack(views)
    Bd, Pl = fl.shape[:2]
    fl, it = fl.reshape(Bd * Pl, _FLOATS), it.reshape(Bd * Pl, _INTS)
    viewid = torch.arange(Bd, dtype=torch.int32,
                          device=fl.device).repeat_interleave(Pl)
    vis = (it[:, 6] > 0) & (it[:, 5] > 0)
    idx, counts = _route_indices(it[:, 2], it[:, 4], vis, R, bh, M)
    valid = (idx >= 0).reshape(-1)
    g = torch.clamp(idx, min=0).reshape(-1)
    sf = fl[g]
    sf = torch.cat([sf[:, :8], torch.where(valid, sf[:, 8], 0.0)[:, None],
                    torch.where(valid, sf[:, 9], torch.inf)[:, None],
                    sf[:, 10:]], dim=1)
    rect = torch.where(valid[:, None], it[g][:, 1:5], 0)
    si = torch.cat([rect, torch.where(valid, viewid[g], 0)[:, None],
                    valid[:, None].to(torch.int32)], dim=1)
    rf = all_to_all(sf, mesh.model_group)                 # (M·R, 11)
    ri = all_to_all(si, mesh.model_group)                 # (M·R, 6)
    splats = _band_splats(rf, ri[:, 0], ri[:, 1], ri[:, 2], ri[:, 3],
                          ri[:, 5] > 0, ri[:, 4], bh, band_lo)
    return splats, (counts.max() > R).to(torch.int32)


def mp_render_views(params_local, cameras: CameraBatch, bg: torch.Tensor, *,
                    config: RasterConfig, mesh: Mesh,
                    active_sh_degree: int | None = None,
                    use_trained_exp: bool = False,
                    alive_local: torch.Tensor | None = None,
                    mean2d_offset_local: torch.Tensor | None = None):
    """This rank's views (its data-axis block) restricted to its tile-row
    band, rendered from its shard of the parameters.

    Returns ``(band_images (Bd, 3, band_rows·16, W), band_invdepth (Bd, 1,
    band_rows·16, W), radii_local (Bd, Pl), diags dict(n_duplicates,
    overflow, max_tile_load))``; rows past H composite the background.
    ``alive_local`` None takes ``params_local.alive``."""
    from gslm_tpu_torch.renderer import _pre, apply_exposure, resolve_impl
    if resolve_impl(config.impl) != "cuda":
        raise NotImplementedError(
            f"impl={config.impl!r}: the model axis renders through the tile "
            "compositor ('auto' or 'cuda')")
    if active_sh_degree is None:
        active_sh_degree = params_local.sh_degree
    H, W = cameras.height, cameras.width
    Bd = cameras.batch_size
    M = mesh.n_model
    bh = band_rows(H, M)
    band_lo = mesh.model_rank * bh
    views = [_pre(params_local, cameras.view(i), config, active_sh_degree,
                  1.0, alive_local, mean2d_offset_local) for i in range(Bd)]
    radii_local = torch.stack([s.radius for s in views])

    Pl = params_local.capacity
    R = config.mp_route_capacity
    key = (Bd, Pl, M, R)
    if key not in _LOGGED:                        # once per shape
        _LOGGED.add(key)
        print(f"[mp raster] splat exchange: "
              f"{'route' if R else 'all_gather'} "
              f"{exchange_bytes(Bd, Pl, M, R)} B/rank (gather would be "
              f"{exchange_bytes(Bd, Pl, M, 0)} B)")
    route_over = torch.zeros((), dtype=torch.int32, device=bg.device)
    if R > 0:
        splats, route_over = _route_band_splats(views, R, bh, mesh, band_lo)
    else:
        splats = _gather_band_splats(views, bh, mesh, band_lo)

    out = rasterize_cuda(splats, Bd * bh * TILE, W, bg, config, view_rows=bh)
    band_h = bh * TILE
    image = out["render"].reshape(3, Bd, band_h, W).transpose(0, 1)
    invd = out["invdepth"].reshape(1, Bd, band_h, W).transpose(0, 1)
    if use_trained_exp:
        image = apply_exposure(image,
                               params_local.exposure[cameras.exposure_idx])
    image = torch.clamp(image, 0.0, 1.0)
    diags = {"n_duplicates": torch.as_tensor(out["n_duplicates"]),
             "overflow": torch.maximum(out["overflow"].to(torch.int32),
                                       route_over),
             "max_tile_load": torch.as_tensor(out["max_tile_load"])}
    return image, invd, radii_local, diags


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh: Mesh
                       ) -> torch.Tensor:
    """Band images (..., band_h, W) extended by ``halo`` rows of the bands
    above and below: every band's top and bottom ``halo`` rows go round in
    one all_gather over the model group, and the global top and bottom
    bands get zeros (ppermute's unpaired destinations in JAX), the zero
    padding the windowed SSIM applies at image edges."""
    M, m = mesh.n_model, mesh.model_rank
    edges = torch.cat([x[..., :halo, :], x[..., -halo:, :]], dim=-2)
    got = all_gather(edges[None], mesh.model_group, dim=0)   # (M, ..., 2h, W)
    zero = torch.zeros_like(x[..., :halo, :])
    top = got[m - 1][..., halo:, :] if m > 0 else zero
    bot = got[m + 1][..., :halo, :] if m < M - 1 else zero
    return torch.cat([top, x, bot], dim=-2)


def _band_inputs(image, cameras: CameraBatch, mesh: Mesh):
    """The band's render masked like the single process's (alpha mask,
    rows past H zeroed), its ground truth and valid-pixel mask."""
    H = cameras.height
    rows = _rows_in_canvas(H, mesh, image.device)
    amask = band_slice(cameras.alpha_mask, H, mesh)
    image = image * amask * rows
    gt = band_slice(cameras.gt_image, H, mesh)
    valid = band_slice(cameras.pixel_valid(), H, mesh)
    return image, gt, valid, rows


def mp_scalar_training_loss(params_local, cameras: CameraBatch,
                            bg: torch.Tensor, *, config: RasterConfig,
                            mesh: Mesh, lambda_dssim: float = 0.2,
                            use_trained_exp: bool = False,
                            active_sh_degree: int | None = None,
                            alive_local: torch.Tensor | None = None,
                            mean2d_offset_local: torch.Tensor | None = None):
    """The band-local first-order loss: its sum over the model group is
    ``scalar_training_loss`` of the whole frames (up to the order of the
    sums). Returns ``(loss_local, info)``.

    The gradient contract (model_raster.py:349-357): ``loss_local`` is
    this rank's partial of the objective; no sum over the ranks sits inside
    the differentiated region. ``info``'s loss, l1 and ssim are the
    reported values, sums over the model group under no_grad; it also
    holds ``radii_local``, the band's masked and raw renders, its invdepth
    and the render's diagnostics."""
    from gslm_tpu_torch.ops.ssim import ssim_map
    image, invd, radii_local, diags = mp_render_views(
        params_local, cameras, bg, config=config, mesh=mesh,
        active_sh_degree=active_sh_degree, use_trained_exp=use_trained_exp,
        alive_local=alive_local, mean2d_offset_local=mean2d_offset_local)
    raw = image
    image, gt, valid, rows = _band_inputs(image, cameras, mesh)

    npix_local = 3.0 * torch.sum(valid, dim=(1, 2, 3))           # (Bd,)
    npix = torch.clamp(all_reduce([npix_local], "sum",
                                  mesh.model_group)[0], min=1.0)
    l1_local = torch.sum(torch.abs(image - gt) * valid, dim=(1, 2, 3))
    ext1 = halo_exchange_rows(image, HALO, mesh)
    ext2 = halo_exchange_rows(gt, HALO, mesh)
    smap = ssim_map(ext1, ext2)[..., HALO:-HALO, :] * valid
    ssim_local = torch.sum(smap, dim=(1, 2, 3))

    lc = ((1.0 - lambda_dssim) * l1_local - lambda_dssim * ssim_local) / npix
    loss_local = torch.mean(lc) + lambda_dssim / mesh.n_model

    lc_g, l1_g, ssim_g = all_reduce([lc.detach(), l1_local.detach(),
                                     ssim_local.detach()], "sum",
                                    mesh.model_group)
    info = {"l1": l1_g / npix, "ssim": ssim_g / npix,
            "loss": torch.mean(lc_g) + lambda_dssim,
            "radii_local": radii_local, "band_render": image,
            # the pre-alpha-mask render, rows past H zeroed: the PSNR
            # metric's input, as the single process scores its raw render
            "band_render_raw": raw * rows, "band_invdepth": invd,
            "diags": diags}
    return loss_local, info


def mp_batch_residuals(params_local, cameras: CameraBatch, bg: torch.Tensor,
                       *, config: RasterConfig, mesh: Mesh,
                       lambda_dssim: float = 0.2, disable_ssim: bool = False,
                       use_trained_exp: bool = False,
                       active_sh_degree: int | None = None,
                       alive_local: torch.Tensor | None = None):
    """The band-local residual vector: this rank's tile-row band of
    ``batch_residuals`` of its views, so the residuals of every rank
    together are the single process's re-laid out. The squared norms are
    summed over both axes by the LM operators, not here."""
    from gslm_tpu_torch.ops.ssim import ssim_map
    from gslm_tpu_torch.solver.residuals import ResidualState
    image, _, _, _ = mp_render_views(
        params_local, cameras, bg, config=config, mesh=mesh,
        active_sh_degree=active_sh_degree, use_trained_exp=use_trained_exp,
        alive_local=alive_local)
    image, gt, valid, _ = _band_inputs(image, cameras, mesh)
    if disable_ssim:
        r = (image - gt) * valid
        return ResidualState(l1=r, ssim=r)
    n = 3.0 * cameras.heights.float() * cameras.widths.float()
    w_l1 = torch.sqrt((1.0 - lambda_dssim) / n)[:, None, None, None]
    w_ssim = torch.sqrt(lambda_dssim / n)[:, None, None, None]
    ext1 = halo_exchange_rows(image, HALO, mesh)
    ext2 = halo_exchange_rows(gt, HALO, mesh)
    smap = ssim_map(ext1, ext2)[..., HALO:-HALO, :]
    r_l1 = w_l1 * torch.sqrt(torch.abs(image - gt) + 1e-6) * valid
    r_ssim = w_ssim * torch.sqrt(torch.abs(1.0 - smap) + 1e-6) * valid
    return ResidualState(l1=r_l1, ssim=r_ssim)


def mp_lm_outer_step(params_local, alive_local, window: CameraBatch,
                     val: CameraBatch, bg: torch.Tensor, win_valid=None,
                     val_valid=None, *, rcfg: RasterConfig, lm,
                     active_sh_degree: int, use_exp: bool, mesh: Mesh,
                     lambda_dssim: float = 0.2):
    """One LM outer step on model-sharded parameters (``window`` and
    ``val`` are this rank's data-axis slices, ``win_valid`` / ``val_valid``
    their (Bd,) weights or None): the residuals banded, CGLS over the
    sharded operators (parameter dots summed over the model axis, residual
    dots over both, Jᵀ·u owner-resident through the exchange's transpose),
    then the line search, whose losses are summed over both axes. Each
    rank's validation slice renders in one pass per alpha, as JAX's does.
    Returns ``(new params_local, info)`` with info's start_loss,
    val_losses, best_alpha and best_val_loss the same on every rank."""
    from gslm_tpu_torch.models import gaussians as G
    from gslm_tpu_torch.models.gaussians import GaussianParams
    from gslm_tpu_torch.solver.cg import cgls_damped_unrolled
    from gslm_tpu_torch.solver.operators import LMOperators
    from gslm_tpu_torch.solver.residuals import res_map

    # the LM residual has no depth term (reference training_loss.py:57)
    rcfg = rcfg.replace(depth_grad=False)

    def weighted(r, w):
        if w is None:
            return r
        return res_map(lambda x: x * w[:, None, None, None], r)

    def residuals(p, cams, w):
        return weighted(mp_batch_residuals(
            p, cams, bg, config=rcfg, mesh=mesh, lambda_dssim=lambda_dssim,
            disable_ssim=lm.disable_ssim, use_trained_exp=use_exp,
            active_sh_degree=active_sh_degree, alive_local=alive_local), w)

    @torch.no_grad()
    def val_loss(p) -> torch.Tensor:
        loss = residuals(p, val, val_valid).loss_scalar
        return all_reduce([loss], "sum", mesh.world_group)[0]

    group_mask = G.param_group_mask(mask_xyz=lm.mask_xyz)
    ops = LMOperators(lambda p: residuals(p, window, win_valid),
                      params_local, group_mask=group_mask, alive=alive_local,
                      axis_name="data", param_axis="model", mesh=mesh)
    start_loss = ops.loss_scalar
    b = res_map(torch.neg, ops.residual)
    damp = lm.damp_dict()
    s = cgls_damped_unrolled(
        ops.matvec, ops.matvec_T, ops.dot, ops.saxpy,
        LMOperators.dampmul_for(damp), b, ops.get_initial_solution(), damp,
        max_iter=lm.cg_max_iter, restart_iter=lm.cg_restart_iter,
        check_divergence=lm.check_divergence)
    del ops

    groups = params_local.groups()
    alphas = torch.tensor([lm.line_search_alpha0 * (0.5 ** i)
                           for i in range(lm.line_search_steps + 1)],
                          device=bg.device)
    losses = torch.stack([val_loss(G.with_groups(
        params_local, G.saxpy(a, s, groups))) for a in alphas])
    best = torch.argmin(losses)
    best_alpha = alphas[best]
    new = G.saxpy(best_alpha, s, groups)
    new_params = GaussianParams(**new, sh_degree=params_local.sh_degree,
                                alive=params_local.alive)
    info = {"start_loss": start_loss, "val_losses": losses,
            "best_alpha": best_alpha, "best_val_loss": losses[best]}
    return new_params, info


@torch.no_grad()
def mp_rebalance(params_l, aux_l, opt_l, *, mesh: Mesh,
                 donate_cap: int = 256):
    """Move alive Gaussians from full model shards to free ones after
    densification (model_raster.py:504), in place.

    Every shard learns every shard's alive count; a shard above ceil(total
    / M) donates up to ``donate_cap`` of its highest-index alive rows,
    numbered donor-major; one all_gather ships the donated parameter and
    Adam-moment rows; each shard below the target claims a disjoint range
    of those numbers (prefix sums of the deficits) and writes them into its
    lowest free slots; the donors kill exactly the claimed rows. Moved
    rows' densification statistics restart at 0. Every choice is a stable
    sort or a prefix sum, so every rank takes the same slots. Returns
    ``(params_l, aux_l, opt_l, moved)``, ``moved`` the rows this shard
    received (0-d int64)."""
    from gslm_tpu_torch.densify import PER_GAUSSIAN
    M, m = mesh.n_model, mesh.model_rank
    alive = params_l.alive
    Cl = alive.shape[0]
    dev = alive.device
    cap = min(donate_cap, Cl)
    iota = torch.arange(Cl, device=dev)
    cap_iota = torch.arange(cap, device=dev)

    counts = all_gather_rows([alive.sum().reshape(1)], mesh.model_group)[0]
    total = counts.sum()
    target = torch.div(total + M - 1, M, rounding_mode="floor")
    donate = torch.clamp(torch.clamp(counts - target, min=0), max=cap)
    deficit = torch.clamp(torch.minimum(torch.clamp(target - counts, min=0),
                                        Cl - counts), max=cap)
    total_claims = torch.minimum(deficit.sum(), donate.sum())

    # donor side: the highest-index alive rows, numbered donor-major
    donor_rows = torch.argsort(-torch.where(alive, iota, -1),
                               stable=True)[:cap]
    donor_base = torch.cumsum(donate, 0)[m] - donate[m]
    donor_claimed = (cap_iota < donate[m]) & (donor_base + cap_iota
                                             < total_claims)
    names = [(src, g) for g in PER_GAUSSIAN for src in ("p", "mu", "nu")]

    def field(src, g):
        return (getattr(params_l, g) if src == "p"
                else (opt_l.mu if src == "mu" else opt_l.nu)[g])

    got = all_gather_rows([field(src, g).detach()[donor_rows]
                           for src, g in names], mesh.model_group)  # (M·cap)

    # number → flattened donation index (donor-major; invalid sort last)
    base_all = torch.cumsum(donate, 0) - donate
    ord_flat = (base_all[:, None] + cap_iota[None, :]).reshape(-1)
    valid_flat = (cap_iota[None, :] < donate[:, None]).reshape(-1)
    big = M * cap
    perm = torch.argsort(torch.where(valid_flat, ord_flat, big), stable=True)

    # receiver side: a disjoint range of numbers into the lowest free slots
    claim_base = torch.cumsum(deficit, 0)[m] - deficit[m]
    my_claim = torch.clamp(total_claims - claim_base, min=0)
    my_claim = torch.minimum(my_claim, deficit[m])
    src_idx = perm[torch.clamp(claim_base + cap_iota, 0, big - 1)]
    take = cap_iota < my_claim
    dst = torch.argsort(torch.where(~alive, iota, Cl), stable=True)[:cap]
    dst, src_idx = dst[take], src_idx[take]
    for (src, g), rows in zip(names, got):
        field(src, g).data[dst] = rows[src_idx]

    kill = donor_rows[donor_claimed]
    alive[dst] = True
    alive[kill] = False
    for f in ("max_radii2d", "xyz_gradient_accum", "denom"):
        getattr(aux_l, f)[dst] = 0.0
    return params_l, aux_l, opt_l, take.sum()


@torch.no_grad()
def band_probe(params_local, cameras: CameraBatch, *, config: RasterConfig,
               mesh: Mesh, active_sh_degree: int | None = None,
               alive_local: torch.Tensor | None = None) -> dict:
    """The model axis's record counts of this rank's views, for the LM
    phase's overflow probe: ``band_aabb`` (Bd, M), the AABB records every
    band's stream holds (this shard's rows summed over the model group:
    the same on every rank of it), and ``sent`` (Bd, M), the records this
    shard routes to each band (``overflow_probe``'s ``route_counts`` row of
    this source)."""
    from gslm_tpu_torch.renderer import band_counts, stack_views
    splats = stack_views(params_local, cameras, config=config,
                         active_sh_degree=active_sh_degree,
                         alive=alive_local)[0]
    band, routed = band_counts(splats, cameras.batch_size, cameras.height,
                               mesh.n_model, src_blocks=1)
    band = all_reduce([band], "sum", mesh.model_group)[0]
    return {"band_aabb": band, "sent": routed[:, 0]}
