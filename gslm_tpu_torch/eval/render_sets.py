"""Render the train/test camera sets of a trained model to PNGs
(gslm_tpu/eval/render_sets.py).

Loads the model at a chosen iteration, renders every view through
``batch_render`` (kernel A on the card) in chunks of 4, the last chunk
padded, and writes ``<model>/{train,test}/ours_<iter>/{renders,gt}/<idx>.png``
for ``eval.metrics`` with the port's PNG writer. There is no overflow
retry: at the capacities the command line gives, a chunk whose records
overflow is written degraded, as in JAX.

Usage: python -m gslm_tpu_torch.eval.render_sets -m <model> [--iteration N]
       [--skip_train] [--skip_test]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from gslm_tpu_torch.data.png import write_png


def save_png(path: str, img_chw: np.ndarray):
    """(3, H, W) float in [0, 1] → 8-bit RGB PNG, rounded as JAX's
    ``save_png`` (clip·255 + 0.5, truncated)."""
    arr = (np.clip(np.asarray(img_chw), 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
    write_png(path, arr.transpose(1, 2, 0))


@torch.no_grad()
def render_set(model_path: str, name: str, iteration: int, metas, params,
               aux, *, bg, rcfg, use_exp: bool, batch: int = 4):
    """Render ``metas`` in chunks of ``batch`` views and write each view's
    render and ground truth. ``aux`` is unused: the mask is
    ``params.alive``."""
    from gslm_tpu_torch.models.cameras import batch_from_metas
    from gslm_tpu_torch.renderer import batch_render

    base = os.path.join(model_path, name, f"ours_{iteration}")
    render_dir = os.path.join(base, "renders")
    gt_dir = os.path.join(base, "gt")
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    # pad the view list to a multiple of the batch, as JAX does
    max_h = max(m.height for m in metas)
    max_w = max(m.width for m in metas)
    for i0 in range(0, len(metas), batch):
        chunk = metas[i0:i0 + batch]
        pad = batch - len(chunk)
        cams = batch_from_metas(chunk + [chunk[-1]] * pad,
                                pad_hw=(max_h, max_w), device=bg.device)
        out = batch_render(params, cams, bg, config=rcfg,
                           use_trained_exp=use_exp, alive=params.alive)
        imgs = out.render.cpu().numpy()
        gts = cams.gt_image.cpu().numpy()
        for j, m in enumerate(chunk):
            idx = i0 + j
            img = imgs[j][:, :m.height, :m.width]
            gt = gts[j][:, :m.height, :m.width]
            if use_exp:   # left half is train-only in train_test_exp mode
                img = img[..., img.shape[-1] // 2:]
                gt = gt[..., gt.shape[-1] // 2:]
            save_png(os.path.join(render_dir, f"{idx:05d}.png"), img)
            save_png(os.path.join(gt_dir, f"{idx:05d}.png"), gt)


def render_sets(model_cfg, iteration: int, *, skip_train=False,
                skip_test=False, tpu=None, pipe=None, device=None):
    """Load ``model_cfg``'s model at ``iteration`` (-1: the newest) on
    ``device`` (default the card) and render its train and test sets."""
    from gslm_tpu_torch import config as cfg_mod
    from gslm_tpu_torch.device import resolve_device
    from gslm_tpu_torch.models.scene import Scene
    from gslm_tpu_torch.train import make_raster_config

    dev = resolve_device(device)
    tpu = tpu or cfg_mod.TpuParams()
    pipe = pipe or cfg_mod.PipelineParams()
    scene = Scene(model_cfg.source_path, model_cfg.model_path,
                  images=model_cfg.images, depths=model_cfg.depths,
                  resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  eval_split=model_cfg.eval,
                  train_test_exp=model_cfg.train_test_exp,
                  sh_degree=model_cfg.sh_degree,
                  load_iteration=iteration, shuffle=False, device=dev)
    bg = torch.ones(3, device=dev) if model_cfg.white_background \
        else torch.zeros(3, device=dev)

    metas = scene.get_train_cameras() + scene.get_test_cameras()
    max_h = max(m.height for m in metas)
    max_w = max(m.width for m in metas)
    rcfg = make_raster_config(tpu, pipe, max_h, max_w, scene.params.capacity)

    if not skip_train:
        render_set(model_cfg.model_path, "train", scene.loaded_iter,
                   scene.get_train_cameras(), scene.params, scene.aux, bg=bg,
                   rcfg=rcfg, use_exp=model_cfg.train_test_exp)
    if not skip_test and scene.get_test_cameras():
        render_set(model_cfg.model_path, "test", scene.loaded_iter,
                   scene.get_test_cameras(), scene.params, scene.aux, bg=bg,
                   rcfg=rcfg, use_exp=model_cfg.train_test_exp)


def build_parser() -> ArgumentParser:
    from gslm_tpu_torch import config as cfg_mod

    parser = ArgumentParser(description="Render trained model views")
    cfg_mod.add_all_args(parser, groups=("model", "pipeline", "tpu"))
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--platform", type=str, default="",
                        help="'' runs on the CUDA card (raises without "
                             "one), 'cpu' on the CPU")
    return parser


def main(argv=None):
    """The command line (``argv``, default ``sys.argv[1:]``) over the
    model's saved ``cfg_args``; ``--platform`` is read from the command
    line alone."""
    import sys

    from gslm_tpu_torch import config as cfg_mod
    from gslm_tpu_torch.device import platform_device

    parser = build_parser()
    argv = sys.argv[1:] if argv is None else argv
    args = cfg_mod.get_combined_args(parser, argv)
    dev = platform_device(parser.parse_args(argv).platform)
    print("Rendering " + args.model_path)
    render_sets(cfg_mod.extract(args, cfg_mod.ModelParams), args.iteration,
                skip_train=args.skip_train, skip_test=args.skip_test,
                tpu=cfg_mod.extract(args, cfg_mod.TpuParams),
                pipe=cfg_mod.extract(args, cfg_mod.PipelineParams),
                device=dev)


if __name__ == "__main__":
    main()
