"""Training steps over the ranks of a mesh (gslm_tpu/parallel/steps.py).

Each step takes the whole camera batch, as JAX's shard_map steps take the
global arrays; every rank renders its contiguous block of the views
(``shard_cameras``) through the single-process code, kernels A, B, C and E
included, and the ranks meet in JAX's collectives, each one flat buffer:

- the Adam step: loss and gradients averaged over the ranks, the
  densification statistics' screen gradients summed, radii and the
  overflow and tile-load metrics the max, the other metrics averaged;
  then the same Adam update on every rank's replicated state;
- the LM step: ``lm_outer_step(axis_name="data")``, whose residual dots,
  Jᵀ·u partials and losses are summed over the ranks.

The model-parallel steps (``make_mp_train_step``, ``make_mp_lm_step``,
``make_mp_densify``) take model-sharded state (``shard_state``): every rank
renders its views' tile-row band from its own rows
(``parallel/model_raster.py``). Per-Gaussian gradients come back to their
owner rows through the splat exchange's transpose; only the replicated
exposure's gradient is summed over the model axis, then every gradient is
averaged over the data axis, and each rank applies Adam to its rows.

``make_sharded_train_step`` and ``make_sharded_lm_step`` are JAX's GSPMD
steps, which compute the single-chip step on sharded arrays: at a model
axis of 1 they are the data-parallel steps, above it the model-parallel
ones, under JAX's signatures.

The trainer modules are imported inside the factories: they import the
solver, which imports ``parallel.mesh``.
"""

from __future__ import annotations

import torch

from gslm_tpu_torch.parallel.mesh import all_reduce, shard_cameras

_MEAN_METRICS = ("loss", "l1", "depth_l1", "psnr")
_MAX_METRICS = ("overflow", "max_tile_load")


def _data_axis_only(mesh) -> None:
    if mesh.shape["model"] != 1:
        raise ValueError(f"a model axis of {mesh.shape['model']}: the "
                         "data-parallel steps replicate the parameters; "
                         "use the make_mp_* steps")


def reduce_summary(mesh, grads: dict, stat_grad, radii, metrics: dict):
    """``train.step_summary``'s parts of every rank combined as JAX's
    ``make_dp_train_step`` combines them: ``grads`` and the mean metrics
    averaged (psum / n), ``stat_grad`` summed, ``radii`` and the max
    metrics the max. Two collectives (float sums, integer maxes)."""
    names = list(grads)
    summed = all_reduce([grads[g] for g in names] + [stat_grad]
                        + [metrics[k] for k in _MEAN_METRICS], "sum",
                        mesh.group)
    maxed = all_reduce([radii] + [metrics[k] for k in _MAX_METRICS], "max",
                       mesh.group)
    n = mesh.shape["data"]
    grads = {g: x / n for g, x in zip(names, summed)}
    stat_grad = summed[len(names)]
    metrics = {k: x / n for k, x in zip(_MEAN_METRICS,
                                         summed[len(names) + 1:])}
    metrics.update(zip(_MAX_METRICS, maxed[1:]))
    return grads, stat_grad, maxed[0], metrics


def dp_apply_update(mesh, params, aux, opt_state, cam, step: int,
                    spatial_lr_scale: float, found, *, opt, sparse_adam: bool,
                    update_stats: bool):
    """``train.apply_update`` over the ranks: ``found`` is this rank's
    ``loss_and_grads`` on its views ``cam``; the parts are reduced
    (``reduce_summary``), then every rank applies the same update to its
    replicated state. Returns ``(params, aux, opt_state, metrics)``."""
    from gslm_tpu_torch.train import step_summary, update_state
    grads, stat_grad, radii, metrics = reduce_summary(
        mesh, *step_summary(cam, found))
    params, aux, opt_state = update_state(
        params, aux, opt_state, step, spatial_lr_scale, grads, stat_grad,
        radii, opt=opt, sparse_adam=sparse_adam, update_stats=update_stats)
    return params, aux, opt_state, metrics


def make_dp_train_step(mesh, *, rcfg, opt, active_sh_degree: int,
                       use_exp: bool, sparse_adam: bool, update_stats: bool):
    """The data-parallel Adam step. Returns ``step_fn(params, aux,
    opt_state, cam, bg, step, spatial_lr_scale, depth_weight) -> (params,
    aux, opt_state, metrics)`` (``train.train_step``'s), ``cam`` the whole
    batch, its view count a multiple of the data axis. Updates the state
    in place, the same on every rank."""
    _data_axis_only(mesh)

    def step_fn(params, aux, opt_state, cam, bg, step, spatial_lr_scale,
                depth_weight):
        from gslm_tpu_torch.train import loss_and_grads
        mine = shard_cameras(mesh, cam)
        found = loss_and_grads(params, mine, bg, depth_weight, rcfg=rcfg,
                               opt=opt, active_sh_degree=active_sh_degree,
                               use_exp=use_exp)
        return dp_apply_update(mesh, params, aux, opt_state, mine, step,
                               spatial_lr_scale, found, opt=opt,
                               sparse_adam=sparse_adam,
                               update_stats=update_stats)

    return step_fn


def make_dp_lm_step(mesh, *, rcfg, lm, active_sh_degree: int, use_exp: bool,
                    lambda_dssim: float = 0.2):
    """The data-parallel LM outer step. Returns ``step_fn(params, alive,
    window, val, bg, win_valid, val_valid) -> (params, info)``: the window,
    the val views and their (B,) weights (None: all 1) are split over the
    data axis and every rank runs ``lm_outer_step(axis_name="data")`` on
    its slices; every rank returns the same step."""
    _data_axis_only(mesh)

    def step_fn(params, alive, window, val, bg, win_valid=None,
                val_valid=None):
        from gslm_tpu_torch.train_lm import lm_outer_step

        def mine(w):
            return None if w is None else w[mesh.block(w.shape[0])]

        return lm_outer_step(
            params, alive, shard_cameras(mesh, window),
            shard_cameras(mesh, val), bg, mine(win_valid), mine(val_valid),
            rcfg=rcfg, lm=lm, active_sh_degree=active_sh_degree,
            use_exp=use_exp, lambda_dssim=lambda_dssim, axis_name="data")

    return step_fn


def make_sharded_train_step(mesh, params, aux, opt_state, camera_batch, *,
                            rcfg, opt, active_sh_degree: int, use_exp: bool,
                            sparse_adam: bool, update_stats: bool):
    """JAX's GSPMD Adam step: ``make_dp_train_step`` at a model axis of 1,
    ``make_mp_train_step`` above it (the state and camera arguments, which
    JAX reads for its sharding trees, are unused)."""
    kw = dict(rcfg=rcfg, opt=opt, active_sh_degree=active_sh_degree,
              use_exp=use_exp, sparse_adam=sparse_adam,
              update_stats=update_stats)
    if mesh.shape["model"] > 1:
        return make_mp_train_step(mesh, params, opt_state, **kw)
    return make_dp_train_step(mesh, **kw)


def make_sharded_lm_step(mesh, params, window_batch, val_batch, *, rcfg, lm,
                         active_sh_degree: int, use_exp: bool,
                         lambda_dssim: float = 0.2):
    """JAX's GSPMD LM step, called as ``step_fn(params, alive, window,
    val, bg) -> (params, info)``: ``make_dp_lm_step`` at a model axis of 1,
    ``make_mp_lm_step`` above it (the batch arguments, which JAX reads for
    its sharding trees, are unused)."""
    kw = dict(rcfg=rcfg, lm=lm, active_sh_degree=active_sh_degree,
              use_exp=use_exp, lambda_dssim=lambda_dssim)
    if mesh.shape["model"] > 1:
        return make_mp_lm_step(mesh, params, **kw)
    return make_dp_lm_step(mesh, **kw)


# ---- the model axis --------------------------------------------------------

def mp_loss_and_grads(mesh, params, cam, bg: torch.Tensor,
                      depth_weight: float, *, rcfg, opt,
                      active_sh_degree: int, use_exp: bool):
    """``train.loss_and_grads`` on model-sharded ``params`` and this rank's
    views ``cam``: the band-local loss (``mp_scalar_training_loss``) plus
    the weighted band-local depth L1, differentiated in every local group
    and the local mean2d offset. No state changes. Returns ``(loss_local,
    info, depth_local, grads, g_m2d)``; ``info["diags"]["overflow"]`` is
    this rank's flag, ``info["depth_weight"]`` the depth term's weight."""
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    from gslm_tpu_torch.parallel.model_raster import (band_slice,
                                                      mp_scalar_training_loss)
    H = cam.height
    m2d = torch.zeros(params.capacity, 2, device=params.xyz.device,
                      requires_grad=True)
    loss_l, info = mp_scalar_training_loss(
        params, cam, bg, config=rcfg, mesh=mesh,
        lambda_dssim=opt.lambda_dssim, use_trained_exp=use_exp,
        active_sh_degree=active_sh_degree, alive_local=params.alive,
        mean2d_offset_local=m2d)
    dmask = band_slice(cam.depth_mask, H, mesh)
    dgt = band_slice(cam.invdepth_gt, H, mesh)
    npix = torch.clamp(all_reduce([torch.sum(dmask)], "sum",
                                  mesh.model_group)[0], min=1.0)
    depth_local = torch.sum(torch.abs(info["band_invdepth"] - dgt)
                            * dmask) / npix
    info["depth_weight"] = depth_weight
    total = loss_l + depth_weight * depth_local
    leaves = [getattr(params, g) for g in PARAM_GROUPS] + [m2d]
    found = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d
             for x, d in zip(leaves, found)]
    return (loss_l.detach(), info, depth_local.detach(),
            dict(zip(PARAM_GROUPS, grads[:-1])), grads[-1])


def mp_apply_update(mesh, params, aux, opt_state, cam, step: int,
                    spatial_lr_scale: float, found, *, opt,
                    sparse_adam: bool, update_stats: bool):
    """``train.apply_update`` on model-sharded state, from this rank's
    ``mp_loss_and_grads`` on its views ``cam``, with JAX's collectives: the
    exposure gradient, the depth L1 and the PSNR's squared errors summed
    over the model axis; then the gradients, the screen-gradient
    statistics (``g_m2d`` times the views) and the metrics over the data
    axis as ``reduce_summary`` takes them (radii the max), the overflow
    and tile-load metrics the max over both axes. Every rank updates its
    rows in place; the replicated exposure is updated alike everywhere.
    Returns ``(params, aux, opt_state, metrics)``."""
    from gslm_tpu_torch.parallel.model_raster import band_slice
    from gslm_tpu_torch.train import update_state
    _, info, depth_local, grads, g_m2d = found
    H, W = cam.height, cam.width
    gt_b = band_slice(cam.gt_image, H, mesh)
    sse = torch.sum((info["band_render_raw"].detach() - gt_b) ** 2,
                    dim=(1, 2, 3))
    g_exp, depth_l1, sse = all_reduce([grads["exposure"], depth_local, sse],
                                      "sum", mesh.model_group)
    grads = grads | {"exposure": g_exp}
    mse = sse / (3.0 * H * W)
    diags = info["diags"]
    over, load = all_reduce([diags["overflow"], diags["max_tile_load"]],
                            "max", mesh.model_group)
    metrics = {"loss": info["loss"] + info["depth_weight"] * depth_l1,
               "l1": torch.mean(info["l1"]), "depth_l1": depth_l1,
               "psnr": torch.mean(-10.0 * torch.log10(
                   torch.clamp(mse, min=1e-12))),
               "overflow": over, "max_tile_load": load}
    radii = torch.amax(info["radii_local"], dim=0)
    grads, stat_grad, radii, metrics = reduce_summary(
        mesh, grads, g_m2d * cam.batch_size, radii, metrics)
    params, aux, opt_state = update_state(
        params, aux, opt_state, step, spatial_lr_scale, grads, stat_grad,
        radii, opt=opt, sparse_adam=sparse_adam, update_stats=update_stats)
    return params, aux, opt_state, metrics


def make_mp_train_step(mesh, params=None, opt_state=None, *, rcfg, opt,
                       active_sh_degree: int, use_exp: bool,
                       sparse_adam: bool, update_stats: bool):
    """The model-parallel Adam step. Returns ``step_fn(params, aux,
    opt_state, cam, bg, step, spatial_lr_scale, depth_weight) -> (params,
    aux, opt_state, metrics)`` (``train.train_step``'s) on this rank's
    model shard of the state, ``cam`` the whole batch, its view count a
    multiple of the data axis. Updates the shard in place. (``params`` and
    ``opt_state``, JAX's examples for its spec trees, are unused.)"""

    def step_fn(params, aux, opt_state, cam, bg, step, spatial_lr_scale,
                depth_weight):
        mine = shard_cameras(mesh, cam)
        found = mp_loss_and_grads(mesh, params, mine, bg, depth_weight,
                                  rcfg=rcfg, opt=opt,
                                  active_sh_degree=active_sh_degree,
                                  use_exp=use_exp)
        return mp_apply_update(mesh, params, aux, opt_state, mine, step,
                               spatial_lr_scale, found, opt=opt,
                               sparse_adam=sparse_adam,
                               update_stats=update_stats)

    return step_fn


def make_mp_lm_step(mesh, params=None, *, rcfg, lm, active_sh_degree: int,
                    use_exp: bool, lambda_dssim: float = 0.2):
    """The model-parallel LM outer step. Returns ``step_fn(params, alive,
    window, val, bg, win_valid, val_valid) -> (params, info)`` on this
    rank's model shard (``alive`` its rows' mask): the window, the val
    views and their (B,) weights (None: all 1) are split over the data
    axis and every rank runs ``mp_lm_outer_step`` on its slices. Each rank
    renders its whole validation slice in one pass per alpha. (``params``,
    JAX's example for its spec tree, is unused.)"""
    from gslm_tpu_torch.parallel.model_raster import mp_lm_outer_step

    def step_fn(params, alive, window, val, bg, win_valid=None,
                val_valid=None):
        def mine(w):
            return None if w is None else w[mesh.block(w.shape[0])]

        return mp_lm_outer_step(
            params, alive, shard_cameras(mesh, window),
            shard_cameras(mesh, val), bg, mine(win_valid), mine(val_valid),
            rcfg=rcfg, lm=lm, active_sh_degree=active_sh_degree,
            use_exp=use_exp, mesh=mesh, lambda_dssim=lambda_dssim)

    return step_fn


def split_noise_rows(mesh, noise):
    """This rank's rows of a density event's split noise: each model index
    takes its block of the whole (C, 3) draws, so every rank of a model
    index draws alike and the model indices differ (JAX folds the model
    index into the key)."""
    return tuple(n[mesh.rows(n.shape[0])] for n in noise)


def make_mp_densify(mesh, params=None, opt_state=None, *,
                    donate_cap: int = 256, rebalance: bool = True):
    """Densification on model-sharded state: ``densify_and_prune`` on each
    shard, then ``mp_rebalance`` (with a model axis above 1). Returns
    ``step(params, aux, opt_state, noise, max_grad, min_opacity, extent,
    max_screen_size, percent_dense) -> (params, aux, opt_state, info)``,
    ``noise`` the whole (C, 3) pair of draws (``split_noise_rows`` takes
    this rank's block), the counts summed over the model axis and
    ``n_rebalanced`` added. Updates the shard in place. (``params`` and
    ``opt_state``, JAX's examples for its spec trees, are unused.)"""
    from gslm_tpu_torch.densify import densify_and_prune
    from gslm_tpu_torch.parallel.model_raster import mp_rebalance

    def step(params, aux, opt_state, noise, max_grad, min_opacity, extent,
             max_screen_size, percent_dense):
        params, aux, opt_state, info = densify_and_prune(
            params, aux, opt_state, split_noise_rows(mesh, noise), max_grad,
            min_opacity, extent, max_screen_size, percent_dense)
        moved = torch.zeros((), dtype=torch.long, device=params.xyz.device)
        if rebalance and mesh.n_model > 1:
            params, aux, opt_state, moved = mp_rebalance(
                params, aux, opt_state, mesh=mesh, donate_cap=donate_cap)
        names = list(info)
        counts = all_reduce([info[k] for k in names] + [moved], "sum",
                            mesh.model_group)
        info = dict(zip(names, counts[:-1]))
        info["n_rebalanced"] = counts[-1]
        return params, aux, opt_state, info

    return step
