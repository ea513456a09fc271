"""Levenberg–Marquardt outer steps (gslm_tpu/train_lm.py): the second
phase of the two-phase trainer.

One outer step (``lm_outer_step``): the residual of a window of views
linearized once, matrix-free damped CGLS on it (J·v in forward mode through
kernel E, Jᵀ·u in reverse mode through kernel C, every CG scalar a device
tensor), then a backtracking line search of 7 step lengths on a fixed set
of validation views, each scored by a chunked forward render. ``lm_phase``
is its host driver: it picks the window and the validation views, probes
the record capacities before and after the step and grows them on
overflow. ``main`` is the two-phase command line: ``train.training`` runs
Adam until ``--jvp_start``, then ``lm_phase`` through its LM hook. With a
mesh (``--mesh_data N`` over N ranks) the window and the validation views
are split over the ranks and the step's sums are all-reduced
(``axis_name="data"``); with a model axis (``--mesh_model M``) the
parameters are sharded too and the step is ``parallel.make_mp_lm_step``.

Usage: python -m gslm_tpu_torch.train_lm -s <dataset> -m <output> [flags]
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from gslm_tpu_torch import config as cfg_mod
from gslm_tpu_torch.models import gaussians as G
from gslm_tpu_torch.models.cameras import CameraBatch
from gslm_tpu_torch.models.gaussians import GaussianParams
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.parallel.mesh import all_reduce, axis_group
from gslm_tpu_torch.renderer import overflow_probe
from gslm_tpu_torch.solver.cg import cgls_damped_unrolled
from gslm_tpu_torch.solver.operators import LMOperators, chunked_residual_fn
from gslm_tpu_torch.solver.residuals import batch_residuals, res_map


def downscale_val_batch(val: CameraBatch, s: int) -> CameraBatch:
    """The same views at 1/s resolution, for line-search ranking renders:
    the cameras keep their matrices and FOV, the ground truth, masks and
    depth maps are s x s average-pooled, the true extents divide by s."""
    H, W = val.height, val.width
    if H % s or W % s:
        raise ValueError(f"ls_val_scale={s} must divide the canvas {H}x{W}")

    def pool(img):
        B, C = img.shape[:2]
        return img.reshape(B, C, H // s, s, W // s, s).mean(dim=(3, 5))

    return val.replace(
        gt_image=pool(val.gt_image), alpha_mask=pool(val.alpha_mask),
        invdepth_gt=pool(val.invdepth_gt), depth_mask=pool(val.depth_mask),
        heights=torch.div(val.heights, s, rounding_mode="floor"),
        widths=torch.div(val.widths, s, rounding_mode="floor"),
        height=H // s, width=W // s)


def lm_outer_step(params: GaussianParams, alive: torch.Tensor | None,
                  window: CameraBatch, val: CameraBatch, bg: torch.Tensor,
                  win_valid: torch.Tensor | None = None,
                  val_valid: torch.Tensor | None = None, *,
                  rcfg: RasterConfig, lm: cfg_mod.LMParams,
                  active_sh_degree: int, use_exp: bool,
                  lambda_dssim: float = 0.2, axis_name: str | None = None):
    """One LM outer step (reference train_jvp.py:221-288). Returns
    ``(new_params, info)``: a new ``GaussianParams`` and dict(start_loss,
    val_losses (7,), best_alpha, best_val_loss, step_norms {group: norm}),
    all as tensors (no host sync).

    A window of more than ``lm.micro_batch`` views renders in micro-batch
    chunks (pad it to a chunk multiple and zero the pads with
    ``win_valid``, (B,) f32; ``val_valid`` likewise for the validation
    views). The validation views render in chunks of ``lm.micro_batch``
    where it divides them, even when the window falls back to one render.

    ``axis_name="data"``: ``window`` and ``val`` are this rank's slices of
    views split over the data axis; residual dots, Jᵀ·u partials and the
    losses are summed over the ranks (``LMOperators``), so every rank
    returns the same step."""
    group = None if axis_name is None else axis_group(axis_name)
    # the LM residual has no depth term (reference training_loss.py:57)
    rcfg = rcfg.replace(depth_grad=False)

    def res_of(cfg):
        def f(p, cams):
            return batch_residuals(p, cams, bg, config=cfg,
                                   lambda_dssim=lambda_dssim,
                                   disable_ssim=lm.disable_ssim,
                                   use_trained_exp=use_exp,
                                   active_sh_degree=active_sh_degree,
                                   alive=alive)
        return f

    nwin, nval = window.batch_size, val.batch_size
    mb, val_mb = micro_batches(lm, nwin, nval)
    if lm.micro_batch > 0 and nwin % lm.micro_batch != 0:
        warnings.warn(
            f"lm_outer_step: window of {nwin} views is not a multiple of "
            f"micro_batch={lm.micro_batch}; falling back to ONE whole-window "
            "render (peak memory scales with the window; pad to a chunk "
            "multiple with win_valid weights as lm_phase does)", stacklevel=2)
    if nwin > mb:
        residual_fn = chunked_residual_fn(res_of(rcfg), window, mb,
                                          view_valid=win_valid)
    elif win_valid is None:
        residual_fn = lambda p: res_of(rcfg)(p, window)  # noqa: E731
    else:
        residual_fn = lambda p: res_map(  # noqa: E731
            lambda x: x * win_valid[:, None, None, None],
            res_of(rcfg)(p, window))

    nch_total = nval // val_mb

    def make_val_loss(valb: CameraBatch, cfg: RasterConfig):
        """Sum of squared residual norms over the val views, one chunk of
        ``val_mb`` views rendered at a time; ``chunk_idx`` selects a subset
        of the chunks (the staged search)."""
        wts = (torch.ones(nval, device=bg.device) if val_valid is None
               else val_valid).reshape(nch_total, val_mb)
        res = res_of(cfg)

        @torch.no_grad()
        def loss_chunks(p, chunk_idx=None) -> torch.Tensor:
            total = torch.zeros((), device=bg.device)
            for c in (range(nch_total) if chunk_idx is None else chunk_idx):
                cams = valb.take(slice(c * val_mb, (c + 1) * val_mb))
                w = wts[c][:, None, None, None]
                r = res_map(lambda x: x * w, res(p, cams))
                total = total + r.loss_scalar
            if group is not None:
                total = all_reduce([total], "sum", group)[0]
            return total

        return loss_chunks

    val_loss = make_val_loss(val, rcfg)

    group_mask = G.param_group_mask(mask_xyz=lm.mask_xyz)
    ops = LMOperators(residual_fn, params, group_mask=group_mask, alive=alive,
                      axis_name=axis_name)
    start_loss = ops.loss_scalar

    b = res_map(torch.neg, ops.residual)             # b = -r
    damp = lm.damp_dict()
    s = cgls_damped_unrolled(
        ops.matvec, ops.matvec_T, ops.dot, ops.saxpy,
        LMOperators.dampmul_for(damp), b, ops.get_initial_solution(), damp,
        max_iter=lm.cg_max_iter, restart_iter=lm.cg_restart_iter,
        check_divergence=lm.check_divergence)
    del ops                                          # the linearization

    # line search: alpha0 halved line_search_steps times, best val loss wins
    groups = params.groups()
    alphas = torch.tensor([lm.line_search_alpha0 * (0.5 ** i)
                           for i in range(lm.line_search_steps + 1)],
                          device=bg.device)

    def at(alpha) -> G.GaussianTensors:
        return G.with_groups(params, G.saxpy(alpha, s, groups))

    ks, vsc = lm.ls_subset_views, lm.ls_val_scale
    if ((0 < ks < nval) or vsc > 1) and lm.line_search_steps > 0:
        # staged search: rank the alphas on a cheaper proxy (a stride-
        # sampled subset of val chunks and/or the val views at 1/vsc
        # resolution), then score the winner on the full set
        if vsc > 1:
            val_r = downscale_val_batch(val, vsc)
            # the ranking stream shrinks ~vsc^2 but never below a record
            # per splat: a 2x margin over the area scaling
            cap = max(512, rcfg.dup_capacity // (vsc * vsc) * 2)
            lcap = (max(512, rcfg.live_capacity // (vsc * vsc) * 2)
                    if rcfg.live_capacity else 0)
            rank_loss = make_val_loss(val_r, rcfg.replace(
                dup_capacity=cap // 256 * 256,
                live_capacity=lcap // 256 * 256))
        else:
            rank_loss = val_loss
        if 0 < ks < nval:
            nch_sub = min(nch_total, max(1, -(-ks // val_mb)))
            sub_idx = tuple(i * nch_total // nch_sub for i in range(nch_sub))
        else:
            sub_idx = None
        losses = torch.stack([rank_loss(at(a), sub_idx) for a in alphas])
        best_alpha = alphas[torch.argmin(losses)]
        new = G.saxpy(best_alpha, s, groups)
        best_val_loss = val_loss(G.with_groups(params, new))
    else:
        losses = torch.stack([val_loss(at(a)) for a in alphas])
        best = torch.argmin(losses)
        best_alpha = alphas[best]
        best_val_loss = losses[best]
        new = G.saxpy(best_alpha, s, groups)

    new_params = GaussianParams(**new, sh_degree=params.sh_degree,
                                alive=params.alive)
    info = {"start_loss": start_loss, "val_losses": losses,
            "best_alpha": best_alpha, "best_val_loss": best_val_loss,
            "step_norms": {g: torch.linalg.vector_norm(s[g])
                           for g in G.PARAM_GROUPS}}
    return new_params, info


def micro_batches(lm: cfg_mod.LMParams, nwin: int, nval: int
                  ) -> tuple[int, int]:
    """The views per render of ``lm_outer_step``'s window and of its
    validation views: ``lm.micro_batch`` (0: the window's size) where it
    divides them, else one render of all of them."""
    mb = val_chunk = lm.micro_batch if lm.micro_batch > 0 else nwin
    if nwin % mb != 0:
        mb = nwin
    val_mb = val_chunk if nval > val_chunk else nval
    if nval % val_mb != 0:
        val_mb = nval      # direct callers with odd sizes: one chunk
    return mb, val_mb


def select_window(num_cams: int, num_images: int, rng: np.random.Generator,
                  stride: int = 1) -> list[int]:
    """Contiguous stride-1 window of views (train_jvp.py:193-206)."""
    n = min(num_images, num_cams)
    start = int(rng.integers(0, max(num_cams - n * stride, 1)))
    return [start + i * stride for i in range(n)]


def val_indices(num_cams: int, lm: cfg_mod.LMParams) -> list[int]:
    """Fixed validation views (train_jvp.py:214-216)."""
    return [(i * lm.val_view_stride) % num_cams
            for i in range(lm.num_val_views)]


def lm_phase(scene, params: GaussianParams, aux, all_train: CameraBatch,
             rcfg: RasterConfig, bg: torch.Tensor, lm: cfg_mod.LMParams,
             iteration: int, rng: np.random.Generator, use_exp: bool,
             lambda_dssim: float, active_sh_degree: int, verbose=True,
             mesh=None):
    """Host driver of one LM iteration: pick the window and the val views,
    run ``lm_outer_step``. Returns ``(params, info, rcfg)``.

    Overflow recovery: the record count of every render unit (a micro-batch
    chunk of the window or of the val views) is probed before the step and
    on the accepted parameters after it; on overflow the whole step re-runs
    from the pre-step parameters at doubled capacities (at most 4 tries).
    ``aux`` carries the ``alive`` mask (a ``GaussianAux`` of the JAX
    package's or anything with ``.alive``; None takes ``params.alive``).
    ``scene`` is unused, as in JAX.

    With a ``mesh`` (``parallel.make_mesh``) every rank draws the same
    window from ``rng``; the window and the val views are padded to a
    multiple of the data axis (times ``micro_batch`` above it) with
    zero-weight views and each rank steps on its contiguous slice
    (``make_dp_lm_step``). Each rank probes its own render units and the
    ranks take the max of their overflow flags, so every rank makes the
    same grow decisions. With a model axis ``params`` is this rank's shard
    and the step ``make_mp_lm_step``, which renders each rank's window
    slice and val slice in one pass each: those are its render units, and
    the probe counts their band records (``band_probe``: the AABB records
    of the fullest band, and at ``mp_route_capacity`` > 0 the records this
    shard routes to each band)."""
    alive = params.alive if aux is None else aux.alive
    n = all_train.batch_size
    win = select_window(n, lm.num_images, rng)
    vidx = val_indices(n, lm)
    dev = bg.device
    n_data = 1 if mesh is None else mesh.shape["data"]
    n_model = 1 if mesh is None else mesh.shape["model"]

    def pad_to_chunk(idx):
        """Pad a view-index list to a micro_batch multiple, and on a mesh
        to a data-axis multiple of that, so every rank's slice chunks
        evenly; the pads repeat the first view and carry weight 0."""
        mb = lm.micro_batch
        multiple = (mb if mb > 0 and len(idx) > mb else 1) * n_data
        if multiple <= 1:
            return idx, None
        pad = (-len(idx)) % multiple
        w = np.ones(len(idx) + pad, np.float32)
        if pad:
            w[len(idx):] = 0.0
            idx = idx + [idx[0]] * pad
        return idx, torch.tensor(w, device=dev)

    win, win_valid = pad_to_chunk(win)
    vidx, val_valid = pad_to_chunk(vidx)
    window = all_train.take(win)
    val = all_train.take(vidx)
    mine = [window, val]                 # the views this rank renders
    if mesh is not None:
        from gslm_tpu_torch.parallel import steps as psteps
        from gslm_tpu_torch.parallel.mesh import shard_cameras
        from gslm_tpu_torch.parallel.model_raster import band_probe
        mine = [shard_cameras(mesh, c) for c in mine]

    def run_step(p, cfg):
        kw = dict(rcfg=cfg, lm=lm, active_sh_degree=active_sh_degree,
                  use_exp=use_exp, lambda_dssim=lambda_dssim)
        if mesh is not None:
            make = psteps.make_mp_lm_step if n_model > 1 else \
                psteps.make_dp_lm_step
            return make(mesh, **kw)(p, alive, window, val, bg, win_valid,
                                    val_valid)
        return lm_outer_step(p, alive, window, val, bg, win_valid, val_valid,
                             **kw)

    # the render units of this rank's views, as its step renders them
    if n_model > 1:
        units = [[list(range(cams.batch_size))] for cams in mine]
    else:
        units = [
            [list(range(c, c + step)) for c in range(0, cams.batch_size,
                                                     step)]
            for cams, step in zip(mine, micro_batches(
                lm, mine[0].batch_size, mine[1].batch_size))]

    def probe(p, cfg) -> bool:
        """True iff any render unit of the window or of the val views (of
        any rank) would overflow cfg's record capacities (or, on a model
        axis, the band streams or the routed exchange's)."""
        over = False
        for cams, groups in zip(mine, units):
            if n_model > 1:
                out = band_probe(p, cams, config=cfg, mesh=mesh,
                                 active_sh_degree=active_sh_degree,
                                 alive_local=alive)
                band = out["band_aabb"].cpu().numpy()
                sent = out["sent"].cpu().numpy()
                for grp in groups:
                    # the AABB count bounds the live count too
                    need = int(band[grp].sum(0).max())
                    over |= (need > cfg.eff_capacity()
                             or need > cfg.dup_capacity)
                    if cfg.mp_route_capacity > 0:
                        over |= (int(sent[grp].sum(0).max())
                                 > cfg.mp_route_capacity)
                continue
            out = overflow_probe(p, cams, config=cfg,
                                 active_sh_degree=active_sh_degree,
                                 alive=alive, per_view=True)
            na = out["n_aabb"].cpu().numpy()
            nl = out["n_live"].cpu().numpy()
            for grp in groups:
                over |= (int(nl[grp].sum()) > cfg.eff_capacity()
                         or int(na[grp].sum()) > cfg.dup_capacity)
        if mesh is not None:
            flag = torch.tensor([int(over)], device=dev)
            over = bool(all_reduce([flag], "max", mesh.world_group)[0])
        return over

    params0 = params
    for _ in range(4):
        if probe(params0, rcfg):
            rcfg = rcfg.grow()
            print(f"\n[ITER {iteration}] LM window exceeds record capacity: "
                  f"growing to dup_capacity={rcfg.dup_capacity}")
            continue
        params, info = run_step(params0, rcfg)
        # the accepted parameters can cross the ceiling the start cleared
        if not probe(params, rcfg):
            break
        rcfg = rcfg.grow()
        print(f"\n[ITER {iteration}] LM step overflowed record capacity: "
              f"re-running at dup_capacity={rcfg.dup_capacity}")
    else:
        print(f"\n[ITER {iteration}] WARNING: LM overflow persists after "
              f"retries (dup_capacity={rcfg.dup_capacity}); this step used "
              f"a degraded render")
        params, info = run_step(params0, rcfg)

    if verbose:
        print(f"\n[ITER {iteration}] LM window {win}: "
              f"loss {float(info['start_loss']):.6f} → val "
              f"{float(info['best_val_loss']):.6f} "
              f"(alpha {float(info['best_alpha']):.3f})")
    return params, info, rcfg


def main(argv=None):
    """The two-phase command line (``argv``, default ``sys.argv[1:]``).
    Returns ``training``'s ``(scene, params, aux, opt_state)``."""
    from gslm_tpu_torch.train import build_parser, training

    parser = build_parser()
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    lm = cfg_mod.extract(args, cfg_mod.LMParams)
    model = cfg_mod.extract(args, cfg_mod.ModelParams)
    opt = cfg_mod.extract(args, cfg_mod.OptimizationParams)
    tpu = cfg_mod.extract(args, cfg_mod.TpuParams)
    rng = np.random.default_rng(0)

    mesh = None
    if tpu.mesh_data * tpu.mesh_model > 1:
        # training starts the same group (or passes through) and builds
        # the same mesh; window and val sizes need not divide mesh_data:
        # lm_phase pads them with zero-weight views
        from gslm_tpu_torch.device import platform_backend
        from gslm_tpu_torch.parallel import (make_mesh,
                                             maybe_initialize_distributed)
        maybe_initialize_distributed(platform_backend(args.platform))
        mesh = make_mesh(tpu.mesh_data, tpu.mesh_model)

    def hook(scene, params, aux, opt_state, iteration, all_train, rcfg, bg):
        active_sh = min(iteration // 1000, params.sh_degree)
        params, info, rcfg = lm_phase(
            scene, params, None, all_train, rcfg, bg, lm, iteration, rng,
            model.train_test_exp, opt.lambda_dssim, active_sh,
            verbose=not getattr(args, "quiet", False), mesh=mesh)
        return params, aux, opt_state, info, rcfg

    print("Optimizing " + args.model_path + f" (LM from {lm.jvp_start})")
    out = training(args, lm_phase_hook=hook)
    print("\nTraining complete.")
    return out


if __name__ == "__main__":
    main()
