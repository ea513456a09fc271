"""Data-parallel training steps over the ranks of a mesh
(gslm_tpu/parallel/steps.py).

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

``make_sharded_train_step`` and ``make_sharded_lm_step`` are JAX's GSPMD
steps; with a model axis of 1 they compute what the data-parallel steps
compute, so here they are those steps under JAX's signatures.

The trainer modules are imported inside the factories: they import the
solver, which imports ``parallel.mesh``.
"""

from __future__ import annotations

from gslm_tpu_torch.parallel.mesh import (MODEL_AXIS_MESSAGE, all_reduce,
                                          shard_cameras)

_MEAN_METRICS = ("loss", "l1", "depth_l1", "psnr")
_MAX_METRICS = ("overflow", "max_tile_load")


def _data_axis_only(mesh) -> None:
    if mesh.shape["model"] != 1:
        raise NotImplementedError(f"a model axis of {mesh.shape['model']}: "
                                  f"{MODEL_AXIS_MESSAGE}")


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
    """JAX's GSPMD Adam step, at a model axis of 1: ``make_dp_train_step``
    (the state and camera arguments, which JAX reads for its sharding
    trees, are unused)."""
    return make_dp_train_step(mesh, rcfg=rcfg, opt=opt,
                              active_sh_degree=active_sh_degree,
                              use_exp=use_exp, sparse_adam=sparse_adam,
                              update_stats=update_stats)


def make_sharded_lm_step(mesh, params, window_batch, val_batch, *, rcfg, lm,
                         active_sh_degree: int, use_exp: bool,
                         lambda_dssim: float = 0.2):
    """JAX's GSPMD LM step, at a model axis of 1: ``make_dp_lm_step``,
    called as ``step_fn(params, alive, window, val, bg) -> (params, info)``
    (the batch arguments, which JAX reads for its sharding trees, are
    unused)."""
    return make_dp_lm_step(mesh, rcfg=rcfg, lm=lm,
                           active_sh_degree=active_sh_degree,
                           use_exp=use_exp, lambda_dssim=lambda_dssim)
