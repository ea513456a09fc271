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
Adam until ``--jvp_start``, then ``lm_phase`` through its LM hook.
Multi-device (``mesh``) comes with the multi-device slice.

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
    views)."""
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name: multi-device LM is not ported yet")
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

    nwin = window.batch_size
    mb = lm.micro_batch if lm.micro_batch > 0 else nwin
    if nwin % mb != 0:
        warnings.warn(
            f"lm_outer_step: window of {nwin} views is not a multiple of "
            f"micro_batch={mb}; falling back to ONE whole-window render "
            "(peak memory scales with the window; pad to a chunk multiple "
            "with win_valid weights as lm_phase does)", stacklevel=2)
        mb = nwin
    if nwin > mb:
        residual_fn = chunked_residual_fn(res_of(rcfg), window, mb,
                                          view_valid=win_valid)
    elif win_valid is None:
        residual_fn = lambda p: res_of(rcfg)(p, window)  # noqa: E731
    else:
        residual_fn = lambda p: res_map(  # noqa: E731
            lambda x: x * win_valid[:, None, None, None],
            res_of(rcfg)(p, window))

    nval = val.batch_size
    val_mb = mb if nval > mb else nval
    if nval % val_mb != 0:
        val_mb = nval      # direct callers with odd sizes: one chunk
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
            return total

        return loss_chunks

    val_loss = make_val_loss(val, rcfg)

    group_mask = G.param_group_mask(mask_xyz=lm.mask_xyz)
    ops = LMOperators(residual_fn, params, group_mask=group_mask, alive=alive)
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
    ``scene`` is unused, as in JAX."""
    if mesh is not None:
        raise NotImplementedError("mesh: multi-device LM is not ported yet")
    alive = params.alive if aux is None else aux.alive
    n = all_train.batch_size
    win = select_window(n, lm.num_images, rng)
    vidx = val_indices(n, lm)
    dev = bg.device

    def pad_to_chunk(idx):
        """Pad a view-index list to a micro_batch multiple; the pads repeat
        the first view and carry weight 0."""
        mb = lm.micro_batch
        if not (mb > 0 and len(idx) > mb):
            return idx, None
        pad = (-len(idx)) % mb
        w = np.ones(len(idx) + pad, np.float32)
        if pad:
            w[len(idx):] = 0.0
            idx = idx + [idx[0]] * pad
        return idx, torch.tensor(w, device=dev)

    win, win_valid = pad_to_chunk(win)
    vidx, val_valid = pad_to_chunk(vidx)
    window = all_train.take(win)
    val = all_train.take(vidx)

    def run_step(p, cfg):
        return lm_outer_step(p, alive, window, val, bg, win_valid, val_valid,
                             rcfg=cfg, lm=lm,
                             active_sh_degree=active_sh_degree,
                             use_exp=use_exp, lambda_dssim=lambda_dssim)

    def render_groups(n_views: int) -> list[list[int]]:
        """View-index groups that share one record stream (one render),
        as lm_outer_step chunks them."""
        mb = lm.micro_batch
        step = mb if 0 < mb < n_views and n_views % mb == 0 else n_views
        return [list(range(c, c + step)) for c in range(0, n_views, step)]

    def probe(p, cfg) -> bool:
        """True iff any render unit of the window or of the val views would
        overflow cfg's record capacities."""
        over = False
        for cams, nv in ((window, len(win)), (val, len(vidx))):
            out = overflow_probe(p, cams, config=cfg,
                                 active_sh_degree=active_sh_degree,
                                 alive=alive, per_view=True)
            na = out["n_aabb"].cpu().numpy()
            nl = out["n_live"].cpu().numpy()
            for grp in render_groups(nv):
                over |= (int(nl[grp].sum()) > cfg.eff_capacity()
                         or int(na[grp].sum()) > cfg.dup_capacity)
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
    rng = np.random.default_rng(0)

    def hook(scene, params, aux, opt_state, iteration, all_train, rcfg, bg):
        active_sh = min(iteration // 1000, params.sh_degree)
        params, info, rcfg = lm_phase(
            scene, params, None, all_train, rcfg, bg, lm, iteration, rng,
            model.train_test_exp, opt.lambda_dssim, active_sh,
            verbose=not getattr(args, "quiet", False))
        return params, aux, opt_state, info, rcfg

    print("Optimizing " + args.model_path + f" (LM from {lm.jvp_start})")
    out = training(args, lm_phase_hook=hook)
    print("\nTraining complete.")
    return out


if __name__ == "__main__":
    main()
