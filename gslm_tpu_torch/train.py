"""First-order (Adam) trainer (gslm_tpu/train.py): the Adam iteration, the
training loop and its command line.

One iteration: render the camera batch, (1-λ)·L1 + λ·(1-SSIM) plus the
weighted depth L1, gradients of every parameter group and of the mean2d
offset by autograd (kernel C and the reversed-tap blur on the card), the
densification statistics, then Adam with per-group learning rates. It is
two functions: ``loss_and_grads`` touches no state, ``apply_update``
updates the statistics, the parameters and the Adam moments in place;
``train_step`` is their composition. The loop reads the render's overflow
flag between the two, so an iteration retried at grown capacities applies
Adam once, from the pre-step state (JAX re-runs its functional step from
the saved state; here an update in place cannot be taken back).

``training`` is the JAX loop: the shuffled view order, the SH ramp, the
random background, the depth-weight schedule, the overflow retry, the
densify and opacity-reset schedule, test / save / checkpoint iterations,
``--start_checkpoint`` resume, the LM hook, the viewer and the profiler
window. Its own draws (split noise, random backgrounds) come from one
``torch.Generator`` seeded 0, which cannot repeat JAX's PRNG.

``--mesh_data N --mesh_model M`` trains over N·M ranks (``parallel``;
launched by ``torchrun --nproc_per_node N·M``, or in a process group the
caller started): every rank draws the same window of N views (a multiple
of N in ``--sgd_batch`` mode) and renders its data-axis block of it. With
M = 1 the state is replicated and the step is
``parallel.dp_apply_update``. With M > 1 each rank holds its block of the
Gaussian rows (``shard_state``), renders its tile-row band
(``parallel.mp_loss_and_grads`` / ``mp_apply_update``), densifies its
shard and rebalances rows across the model axis (``make_mp_densify``); the
state is gathered over the model axis before a test, a save, a checkpoint
or a viewer frame, as JAX's sharded arrays gather implicitly, and
``training`` returns this rank's shard. Density events run on every rank
from generators seeded alike, and only rank 0 prints and writes files (the
others wait at a barrier where it writes).

Usage: python -m gslm_tpu_torch.train -s <dataset> -m <output> [flags]
(on the card; ``--platform cpu`` runs on the CPU)
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from argparse import ArgumentParser

import numpy as np
import torch

from gslm_tpu_torch import config as cfg_mod
from gslm_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from gslm_tpu_torch.config import OptimizationParams
from gslm_tpu_torch.densify import (add_densification_stats,
                                    densify_and_prune, reset_opacity)
from gslm_tpu_torch.device import platform_backend, platform_device
from gslm_tpu_torch.models.cameras import CameraBatch, batch_from_metas
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                             GaussianParams)
from gslm_tpu_torch.models.scene import Scene
from gslm_tpu_torch.optim import (AdamState, adam_step, group_learning_rates,
                                  init_adam)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.parallel.mesh import (all_reduce, barrier, gather_state,
                                          make_mesh,
                                          maybe_initialize_distributed,
                                          shard_cameras, shard_state)
from gslm_tpu_torch.renderer import batch_render
from gslm_tpu_torch.solver.residuals import scalar_training_loss
from gslm_tpu_torch.utils.general import get_expon_lr_func, safe_state
from gslm_tpu_torch.utils.image import psnr
from gslm_tpu_torch.utils.profiling import IterTimer, span, trace


def make_raster_config(tpu: cfg_mod.TpuParams, pipe: cfg_mod.PipelineParams,
                       height: int, width: int,
                       n_gaussians: int) -> RasterConfig:
    """Heuristic rasterizer capacities for a scene of ``n_gaussians``: the
    JAX heuristic. ``height`` and ``width`` size JAX's ``tile_chunk``, a
    TPU-only field the port does not have. With culling, a zero
    ``live_capacity`` picks 7/8 of the AABB capacity (the surviving stream
    measured ~82 %)."""
    dup = min(tpu.dup_capacity, max(1 << 14, 16 * n_gaussians))
    live = tpu.live_capacity or (dup - (dup >> 3) if tpu.raster_cull else 0)
    live = (live // 256) * 256
    return RasterConfig(dup_capacity=dup, antialiasing=pipe.antialiasing,
                        impl=tpu.raster_impl, cull=tpu.raster_cull,
                        live_capacity=live,
                        mp_route_capacity=tpu.mp_route_capacity)


def loss_and_grads(params: GaussianParams, cam: CameraBatch,
                   bg: torch.Tensor, depth_weight: float, *,
                   rcfg: RasterConfig, opt: OptimizationParams,
                   active_sh_degree: int, use_exp: bool):
    """The loss of one Adam iteration and its gradients; no state changes.

    Returns ``(loss, info, depth_l1, grads, g_m2d)``: ``info`` is
    ``scalar_training_loss``'s dict, ``grads`` the gradient of every
    parameter group (zeros for a group the loss does not reach, as
    ``jax.grad`` gives), ``g_m2d`` (P, 2) the mean2d offset's cotangent."""
    m2d = torch.zeros(params.capacity, 2, device=params.xyz.device,
                      requires_grad=True)
    loss, info = scalar_training_loss(
        params, cam, bg, config=rcfg, lambda_dssim=opt.lambda_dssim,
        use_trained_exp=use_exp, active_sh_degree=active_sh_degree,
        alive=params.alive, mean2d_offset=m2d)
    out = info["render"]
    # depth regularization (reference train.py:129-140)
    npix = torch.clamp(torch.sum(cam.depth_mask), min=1.0)
    depth_l1 = torch.sum(torch.abs(out.invdepth - cam.invdepth_gt)
                         * cam.depth_mask) / npix
    loss = loss + depth_weight * depth_l1
    leaves = [getattr(params, g) for g in PARAM_GROUPS] + [m2d]
    with span("gslm.backward"):
        found = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d
             for x, d in zip(leaves, found)]
    return (loss.detach(), info, depth_l1.detach(),
            dict(zip(PARAM_GROUPS, grads[:-1])), grads[-1])


def step_summary(cam: CameraBatch, found):
    """What an Adam update takes from ``found`` (``loss_and_grads``'s
    output) on ``cam``'s views: ``(grads, stat_grad, radii, metrics)``,
    ``stat_grad`` (P, 2) the sum of the per-view screen gradients (the
    mean-over-views 1/B of ``g_m2d`` undone, so the statistics do not
    depend on the batch size), ``radii`` (P,) the max over the views and
    the metrics as 0-d tensors (no host sync). The data-parallel step
    reduces these over the ranks."""
    loss, info, depth_l1, grads, g_m2d = found
    out = info["render"]
    render = out.render.detach()
    metrics = {"loss": loss, "l1": torch.mean(info["l1"].detach()),
               "depth_l1": depth_l1,
               "psnr": torch.mean(psnr(render, cam.gt_image)),
               "overflow": torch.amax(out.overflow),
               "max_tile_load": torch.amax(out.max_tile_load)}
    return grads, g_m2d * cam.batch_size, torch.amax(out.radii, dim=0), \
        metrics


def update_state(params: GaussianParams, aux: GaussianAux,
                 opt_state: AdamState, step: int, spatial_lr_scale: float,
                 grads: dict, stat_grad: torch.Tensor, radii: torch.Tensor, *,
                 opt: OptimizationParams, sparse_adam: bool,
                 update_stats: bool):
    """The densification statistics, then Adam, from ``step_summary``'s
    parts. Updates ``params`` and ``opt_state`` in place; returns
    ``(params, aux, opt_state)``."""
    if update_stats:
        aux = add_densification_stats(aux, stat_grad, radii)
    lrs = group_learning_rates(opt, step, spatial_lr_scale)
    visible = (radii > 0) if sparse_adam else None
    params, opt_state = adam_step(params, grads, opt_state, lrs, visible)
    return params, aux, opt_state


def apply_update(params: GaussianParams, aux: GaussianAux,
                 opt_state: AdamState, cam: CameraBatch, step: int,
                 spatial_lr_scale: float, found, *, opt: OptimizationParams,
                 sparse_adam: bool, update_stats: bool):
    """The rest of one Adam iteration, given ``found``, the output of
    ``loss_and_grads``: ``step_summary`` then ``update_state``. Updates
    ``params`` and ``opt_state`` in place; returns ``(params, aux,
    opt_state, metrics)`` with the metrics as 0-d tensors (no host
    sync)."""
    grads, stat_grad, radii, metrics = step_summary(cam, found)
    params, aux, opt_state = update_state(
        params, aux, opt_state, step, spatial_lr_scale, grads, stat_grad,
        radii, opt=opt, sparse_adam=sparse_adam, update_stats=update_stats)
    return params, aux, opt_state, metrics


def train_step(params: GaussianParams, aux: GaussianAux,
               opt_state: AdamState, cam: CameraBatch, bg: torch.Tensor,
               step: int, spatial_lr_scale: float, depth_weight: float, *,
               rcfg: RasterConfig, opt: OptimizationParams,
               active_sh_degree: int, use_exp: bool, sparse_adam: bool,
               update_stats: bool):
    """One Adam iteration over a (usually B=1) camera batch:
    ``loss_and_grads`` then ``apply_update``. Updates ``params`` and
    ``opt_state`` in place."""
    with span("gslm.train_step"):
        found = loss_and_grads(params, cam, bg, depth_weight, rcfg=rcfg,
                               opt=opt, active_sh_degree=active_sh_degree,
                               use_exp=use_exp)
        return apply_update(params, aux, opt_state, cam, step,
                            spatial_lr_scale, found, opt=opt,
                            sparse_adam=sparse_adam,
                            update_stats=update_stats)


@torch.no_grad()
def evaluate(params: GaussianParams, aux, cams: CameraBatch, bg, rcfg,
             active_sh_degree, use_exp) -> dict:
    """L1 and PSNR of one batched render of ``cams`` (no overflow retry, as
    in JAX). ``aux`` is unused: the mask is ``params.alive``."""
    out = batch_render(params, cams, bg, config=rcfg,
                       active_sh_degree=active_sh_degree,
                       use_trained_exp=use_exp, alive=params.alive)
    l1 = torch.mean(torch.abs(out.render - cams.gt_image))
    return {"l1": float(l1),
            "psnr": float(torch.mean(psnr(out.render, cams.gt_image)))}


def split_noise(gen: torch.Generator, capacity: int, device) -> tuple:
    """The two (C, 3) standard normal draws of one densification event (the
    split children's offsets), from the loop's generator."""
    return tuple(torch.randn((capacity, 3), generator=gen, device=device)
                 for _ in range(2))


def training(args, *, lm_phase_hook=None):
    """The training loop over ``args`` (``build_parser``'s namespace).
    Returns ``(scene, params, aux, opt_state)``: on a model axis this
    rank's shard of the state.

    ``lm_phase_hook(scene, params, aux, opt_state, iteration, all_train,
    rcfg, bg)`` runs the iterations from ``--jvp_start`` on and returns
    ``(params, aux, opt_state, info, rcfg)``: ``info["best_val_loss"]``
    feeds the progress line, and the returned ``rcfg`` (grown by the
    hook's overflow probe) is kept."""
    platform = getattr(args, "platform", "")
    model = cfg_mod.extract(args, cfg_mod.ModelParams)
    opt = cfg_mod.extract(args, cfg_mod.OptimizationParams)
    pipe = cfg_mod.extract(args, cfg_mod.PipelineParams)
    tpu = cfg_mod.extract(args, cfg_mod.TpuParams)
    # the data axis: one process per rank (a mesh that must fill the world)
    dist_up = maybe_initialize_distributed(platform_backend(platform))
    mesh = None
    if tpu.mesh_data * tpu.mesh_model > 1 or (
            dist_up and torch.distributed.get_world_size() > 1):
        mesh = make_mesh(tpu.mesh_data, tpu.mesh_model)
    main_rank = mesh is None or mesh.is_main
    mp = mesh is not None and mesh.n_model > 1
    safe_state(getattr(args, "quiet", False) or not main_rank)
    dev = platform_device(platform)
    if mesh is not None:
        print(f"{'Model' if mp else 'Data'}-parallel training over mesh "
              f"{mesh.shape} ({tpu.mesh_data} views/step)")
    if getattr(args, "detect_anomaly", False):
        from gslm_tpu_torch.utils.profiling import enable_nan_debugging
        enable_nan_debugging()

    # JAX seeds the global `random` in safe_state, shuffles the cameras
    # with it in Scene, then the view order: one Random(0) does the same
    order_rng = random.Random(0)
    # the other ranks' Scene writes nothing (no model path)
    scene = Scene(model.source_path, model.model_path if main_rank else "",
                  images=model.images,
                  depths=model.depths, resolution=model.resolution,
                  white_background=model.white_background,
                  eval_split=model.eval, train_test_exp=model.train_test_exp,
                  sh_degree=model.sh_degree, capacity=tpu.capacity or None,
                  device=dev, rng=order_rng)
    if main_rank:
        cfg_mod.save_cfg_args(model.model_path, args)

    params, aux = scene.params, scene.aux
    opt_state = init_adam(params)
    first_iter = 0
    spatial_lr_scale = scene.cameras_extent
    if getattr(args, "start_checkpoint", ""):
        params, aux, opt_state, first_iter, spatial_lr_scale = \
            load_checkpoint(args.start_checkpoint, device=dev)
        n_rows = params.exposure.shape[0]
        n_mapped = len(scene.exposure_mapping)
        if n_rows < n_mapped:
            raise ValueError(
                f"{args.start_checkpoint} holds {n_rows} exposure rows where "
                f"the scene maps {n_mapped} images (a checkpoint written "
                f"without --train_test_exp cannot resume with it)")
        print(f"Restored checkpoint at iteration {first_iter}")
    if mesh is not None:
        # every rank starts from rank 0's state, bit for bit (its block of
        # rows on a model axis)
        params, aux, opt_state = shard_state(mesh, params, aux, opt_state)
        barrier(mesh)

    train_metas = scene.get_train_cameras()
    all_train = batch_from_metas(train_metas, device=dev)
    test_metas = scene.get_test_cameras()
    all_test = batch_from_metas(
        test_metas, pad_hw=(all_train.height, all_train.width),
        device=dev) if test_metas else None

    rcfg = make_raster_config(tpu, pipe, all_train.height, all_train.width,
                              params.capacity)
    if not any(m.depth_reliable for m in train_metas):
        # no usable depth maps: the depth-L1 term is identically zero
        rcfg = rcfg.replace(depth_grad=False)

    bg_default = torch.ones(3, device=dev) if model.white_background \
        else torch.zeros(3, device=dev)
    depth_w_fn = get_expon_lr_func(opt.depth_l1_weight_init,
                                   opt.depth_l1_weight_final,
                                   max_steps=opt.iterations)
    sparse = opt.optimizer_type == "sparse_adam"
    mp_densify = None
    if mesh is None:
        update = apply_update
    else:
        from gslm_tpu_torch.parallel import steps as psteps
        step_update = psteps.mp_apply_update if mp else \
            psteps.dp_apply_update

        def update(*a, **k):
            return step_update(mesh, *a, **k)
        if mp:
            mp_densify = psteps.make_mp_densify(mesh)

    def whole_state(with_opt: bool):
        """The whole parameters (and with ``with_opt`` the statistics and
        Adam moments) on the main rank: under a model axis its model group
        gathers them onto it, the other data rows skip; None on every
        other rank."""
        if not mp:
            return (params, aux, opt_state) if main_rank else None
        if mesh.rank != 0:
            return None
        if with_opt:
            return gather_state(mesh, params, aux, opt_state)
        whole = gather_state(mesh, params)
        return None if whole is None else (whole, None, None)

    def n_alive() -> int:
        n = params.alive.sum()
        if mp:
            n = all_reduce([n], "sum", mesh.model_group)[0]
        return int(n)

    writer = None
    try:
        if main_rank:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(model.model_path)
    except Exception:
        print("Tensorboard not available: not logging progress")

    test_iterations = set(getattr(args, "test_iterations", None)
                          or [7000, 30000])
    save_iterations = set(getattr(args, "save_iterations", None)
                          or [7000, 30000])
    ckpt_iterations = set(getattr(args, "checkpoint_iterations", None) or [])

    viewer = None
    if main_rank and not getattr(args, "disable_viewer", False):
        try:
            from gslm_tpu_torch.viewer import ViewerServer
            viewer = ViewerServer(getattr(args, "ip", "127.0.0.1"),
                                  getattr(args, "port", 6009))
        except OSError as e:
            print(f"Viewer server disabled ({e})")
    # a model axis gathers the shards for the viewer's frames: every rank
    # learns whether rank 0 serves one
    mp_viewer = mp and bool(all_reduce(
        [torch.tensor(int(viewer is not None), device=dev)], "max",
        mesh.world_group)[0])

    gen = torch.Generator(device=dev).manual_seed(0)
    np_rng = np.random.default_rng(0)
    indices: list[int] = []
    ema_loss = 0.0
    t_start = time.time()
    jvp_start = getattr(args, "jvp_start", opt.iterations + 1)

    iter_timer = IterTimer()
    profile_dir = getattr(args, "profile_dir", "") if main_rank else ""
    profile_from = getattr(args, "profile_from", 50)
    profile_until = profile_from + getattr(args, "profile_steps", 10)
    profiler = contextlib.ExitStack()
    profiling = False

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        for iteration in range(first_iter + 1, opt.iterations + 1):
            if profile_dir:
                if iteration == profile_from and not profiling:
                    sync()
                    profiler.enter_context(trace(profile_dir))
                    profiling = True
                elif iteration == profile_until and profiling:
                    sync()
                    profiler.close()
                    profiling = False
                    print(f"\n[ITER {iteration}] wrote profiler trace to "
                          f"{profile_dir}")
            active_sh = min(iteration // 1000, params.sh_degree)
            if mp_viewer:
                client = viewer is not None and (
                    viewer.conn is not None or viewer.try_connect())
                if all_reduce([torch.tensor(int(client), device=dev)], "max",
                              mesh.world_group)[0]:
                    shown = whole_state(False)
                    if viewer is not None:
                        viewer.poll(shown[0], None, bg_default, rcfg=rcfg,
                                    active_sh_degree=active_sh,
                                    source_path=model.source_path,
                                    training_done=iteration >= opt.iterations)
                    del shown
            elif viewer is not None:
                viewer.poll(params, aux, bg_default, rcfg=rcfg,
                            active_sh_degree=active_sh,
                            source_path=model.source_path,
                            training_done=iteration >= opt.iterations)
            if lm_phase_hook is not None and iteration >= jvp_start:
                # LM outer steps; eval/save/checkpoint and the densify /
                # opacity-reset schedule below still apply
                # rcfg back: the LM probe may have grown the capacities
                params, aux, opt_state, lm_info, rcfg = lm_phase_hook(
                    scene, params, aux, opt_state, iteration, all_train,
                    rcfg, bg_default)
                loss_f = float(lm_info["best_val_loss"])
                ema_loss = 0.4 * loss_f + 0.6 * ema_loss
                if iteration % 10 == 0:
                    print(f"Training {iteration}/{opt.iterations}: "
                          f"ValLoss={ema_loss:.7f}, P={n_alive()}")
                iter_ms = iter_timer.tick()
                if writer is not None and lm_info is not None:
                    writer.add_scalar("train_loss_patches/total_loss",
                                      float(lm_info["start_loss"]),
                                      iteration)
                    writer.add_scalar("lm/best_val_loss", loss_f, iteration)
                    writer.add_scalar("lm/best_alpha",
                                      float(lm_info["best_alpha"]), iteration)
                    writer.add_scalar("iter_time", iter_ms, iteration)
            else:
                if getattr(args, "sgd_batch", False) or mesh is not None:
                    # a strided multi-view window (train_sgd), or one view
                    # per rank: the ranks draw the same window
                    from gslm_tpu_torch.train_sgd import select_window
                    n_views = (getattr(args, "num_images", 5)
                               if getattr(args, "sgd_batch", False)
                               else tpu.mesh_data)
                    if mesh is not None:
                        n_views = max(n_views, tpu.mesh_data)
                        n_views -= n_views % tpu.mesh_data
                    win = select_window(len(train_metas), n_views, np_rng)
                    cam = all_train.take(win)
                    # per-view depth gating: zero the unreliable views'
                    # depth masks instead of gating the window on win[0]
                    rel = np.array([train_metas[i].depth_reliable
                                    for i in win], np.float32)
                    depth_ok = bool(rel.any())
                    if not rel.all():
                        cam = cam.replace(depth_mask=cam.depth_mask * torch
                                          .tensor(rel, device=dev)[:, None,
                                                                   None, None])
                    if mesh is not None:
                        cam = shard_cameras(mesh, cam)   # this rank's views
                else:
                    if not indices:
                        indices = list(range(len(train_metas)))
                        order_rng.shuffle(indices)
                    idx = indices.pop()
                    cam = all_train.take(slice(idx, idx + 1))
                    depth_ok = train_metas[idx].depth_reliable

                if opt.random_background:
                    bg = torch.rand(3, generator=gen, device=dev)
                else:
                    bg = bg_default

                in_densify = iteration < opt.densify_until_iter
                dw = depth_w_fn(iteration) if depth_ok else 0.0

                # overflow recovery: re-run at doubled capacities; Adam
                # applies once, on the clean attempt (or, degraded, on the
                # last), so failed attempts never reach the parameters
                for attempt in range(3):
                    kw = dict(rcfg=rcfg, opt=opt, active_sh_degree=active_sh,
                              use_exp=model.train_test_exp)
                    if mp:
                        found = psteps.mp_loss_and_grads(mesh, params, cam,
                                                         bg, dw, **kw)
                        over = found[1]["diags"]["overflow"]
                    else:
                        found = loss_and_grads(params, cam, bg, dw, **kw)
                        over = torch.amax(found[1]["render"].overflow)
                    if mesh is not None:
                        # the same decision on every rank
                        over = all_reduce([over], "max",
                                          mesh.world_group)[0]
                    clean = int(over) == 0
                    if clean or attempt == 2:
                        params, aux, opt_state, metrics = update(
                            params, aux, opt_state, cam, iteration,
                            spatial_lr_scale, found, opt=opt,
                            sparse_adam=sparse, update_stats=in_densify)
                    del found
                    if clean:
                        break
                    rcfg = rcfg.grow()
                    print(f"\n[ITER {iteration}] duplicate-buffer overflow: "
                          f"retrying at dup_capacity={rcfg.dup_capacity}")
                else:
                    print(f"\n[ITER {iteration}] WARNING: overflow persists "
                          f"after retries (dup_capacity={rcfg.dup_capacity}"
                          f"); this step used a degraded render")

                loss_f = float(metrics["loss"])
                ema_loss = 0.4 * loss_f + 0.6 * ema_loss
                if iteration % 10 == 0:
                    print(f"Training {iteration}/{opt.iterations}: "
                          f"Loss={ema_loss:.7f}, P={n_alive()}")
                iter_ms = iter_timer.tick()
                if writer is not None:
                    writer.add_scalar("train_loss_patches/total_loss", loss_f,
                                      iteration)
                    writer.add_scalar("train_loss_patches/l1_loss",
                                      float(metrics["l1"]), iteration)
                    writer.add_scalar("iter_time", iter_ms, iteration)

            # --- densification schedule (reference train.py:160-174; it
            # stays active in the LM phase like train_jvp.py:294-341) ---
            if iteration < opt.densify_until_iter \
                    and iteration > opt.densify_from_iter \
                    and iteration % opt.densification_interval == 0:
                # the whole capacity's draws; a model shard takes its rows
                capacity = params.capacity * (mesh.n_model if mp else 1)
                noise = split_noise(gen, capacity, dev)
                size_thr = 20.0 if iteration > opt.opacity_reset_interval \
                    else 0.0
                params, aux, opt_state, info = (mp_densify or
                                                densify_and_prune)(
                    params, aux, opt_state, noise, opt.densify_grad_threshold,
                    0.005, scene.cameras_extent, size_thr, opt.percent_dense)
                del noise
                if int(info["n_dropped"]) > 0:
                    print(f"\n[ITER {iteration}] capacity full: dropped "
                          f"{int(info['n_dropped'])} densification requests "
                          f"(capacity={capacity})")
            if iteration < opt.densify_until_iter and (
                    iteration % opt.opacity_reset_interval == 0 or (
                        model.white_background
                        and iteration == opt.densify_from_iter)):
                params, opt_state = reset_opacity(params, opt_state)

            if iteration in test_iterations | save_iterations \
                    | ckpt_iterations:
                whole = whole_state(iteration in ckpt_iterations)
            if iteration in test_iterations and main_rank:
                stats = {"train": evaluate(
                    whole[0], None, all_train.take(slice(0, min(5, len(
                        train_metas)))), bg_default, rcfg, active_sh,
                    model.train_test_exp)}
                if all_test is not None:
                    stats["test"] = evaluate(whole[0], None, all_test,
                                             bg_default, rcfg, active_sh,
                                             model.train_test_exp)
                print(f"\n[ITER {iteration}] " + "  ".join(
                    f"{k}: L1 {v['l1']:.4f} PSNR {v['psnr']:.2f}"
                    for k, v in stats.items()))
                if writer is not None:
                    for k, v in stats.items():
                        writer.add_scalar(f"{k}/loss_viewpoint_psnr",
                                          v["psnr"], iteration)
                    _report_extras(writer, whole[0], all_train, bg_default,
                                   rcfg, active_sh, model.train_test_exp,
                                   iteration)
            if iteration in save_iterations:
                print(f"\n[ITER {iteration}] Saving Gaussians")
                if main_rank:
                    scene.save(iteration, whole[0])
                barrier(mesh)
            if iteration in ckpt_iterations:
                if main_rank:
                    save_checkpoint(os.path.join(model.model_path,
                                                 f"chkpnt{iteration}.npz"),
                                    *whole, iteration, spatial_lr_scale)
                barrier(mesh)
            whole = None
    finally:
        profiler.close()
        if viewer is not None:
            viewer.close()

    print(f"\nTraining complete in {time.time() - t_start:.1f}s")
    scene.params, scene.aux = params, aux
    return scene, params, aux, opt_state


def _report_extras(writer, params, all_train, bg, rcfg, active_sh, use_exp,
                   iteration):
    """The reference's training_report extras (train.py:221-256): the
    first train views' renders, the opacity histogram, the point count."""
    try:
        with torch.no_grad():
            out = batch_render(params, all_train.take(slice(0, 5)), bg,
                               config=rcfg, active_sh_degree=active_sh,
                               use_trained_exp=use_exp, alive=params.alive)
            for i in range(out.render.shape[0]):
                writer.add_image(f"renders/view_{i:03d}",
                                 out.render[i].cpu().numpy(), iteration)
            writer.add_histogram(
                "scene/opacity_histogram",
                torch.sigmoid(params.opacity[params.alive, 0]).cpu().numpy(),
                iteration)
            writer.add_scalar("total_points", int(params.alive.sum()),
                              iteration)
    except Exception as e:     # TB extras must never kill a run
        print(f"(tensorboard extras skipped: {e})")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="3DGS training on the card")
    cfg_mod.add_all_args(parser)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7000, 30000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7000, 30000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="autograd anomaly mode: raise at the first "
                             "backward op that produces a NaN")
    parser.add_argument("--platform", type=str, default="",
                        help="'' runs on the CUDA card (raises without "
                             "one), 'cpu' on the CPU")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of iterations "
                             "profile_from..profile_from+profile_steps")
    parser.add_argument("--profile_from", type=int, default=50)
    parser.add_argument("--profile_steps", type=int, default=10)
    return parser


def main(argv=None):
    """The command line (``argv``, default ``sys.argv[1:]``). Returns
    ``training``'s ``(scene, params, aux, opt_state)``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    print("Optimizing " + args.model_path)
    out = training(args)
    print("\nTraining complete.")
    return out


if __name__ == "__main__":
    main()
