"""Quality metrics over rendered sets: SSIM / PSNR / LPIPS
(gslm_tpu/eval/metrics.py).

For every ``<model>/test/ours_<iter>`` directory, pair renders with gt,
compute the metrics (SSIM through kernel B on the card, LPIPS through
``eval/lpips.py``) and write ``results.json`` and ``per_view.json`` in the
JAX package's schema. Images are read by the port's own PNG codec. LPIPS
needs a weight file (``eval/lpips.py``); without one, or with
``--no_lpips``, it is reported as null, with the JAX package's note.

Usage: python -m gslm_tpu_torch.eval.metrics -m <model_path> [...]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from gslm_tpu_torch.data.png import load_image
from gslm_tpu_torch.device import platform_device, resolve_device
from gslm_tpu_torch.eval import lpips as lpips_mod
from gslm_tpu_torch.ops.ssim import ssim
from gslm_tpu_torch.utils.image import psnr


def read_images(renders_dir: str, gt_dir: str):
    """Paired (3, H, W) float32 images in [0, 1] of two directories."""
    names = sorted(os.listdir(renders_dir))
    renders, gts = [], []
    for name in names:
        for d, acc in ((renders_dir, renders), (gt_dir, gts)):
            img = np.asarray(load_image(os.path.join(d, name)),
                             np.float32)[..., :3] / 255.0
            acc.append(img.transpose(2, 0, 1))
    return names, renders, gts


@torch.no_grad()
def pair_metrics(render: torch.Tensor, gt: torch.Tensor):
    """(SSIM, PSNR) of one (3, H, W) render against its ground truth, as
    0-d tensors on the images' device."""
    return ssim(render[None], gt[None]), psnr(render, gt)


def evaluate_dir(method_dir: str, use_lpips: bool = True, *, device=None):
    """Metrics over one ours_<iter> directory (``renders/`` and ``gt/``).
    Returns (summary, per_view) in the JAX package's schema; LPIPS is null
    without its weights (with a printed note when ``use_lpips`` asks for
    it)."""
    dev = resolve_device(device)
    names, renders, gts = read_images(os.path.join(method_dir, "renders"),
                                      os.path.join(method_dir, "gt"))
    lpips_ok = use_lpips and lpips_mod.available()
    if use_lpips and not lpips_ok:
        print(f"LPIPS weights not found at {lpips_mod.default_weight_path()}"
              " — reporting LPIPS: null. Export them once on any box with"
              " torchvision (tools/export_lpips_weights.py) and point"
              " GSLM_LPIPS_WEIGHTS at the npz.")
    ssims, psnrs, lpipss = [], [], []
    for r, g in zip(renders, gts):
        r, g = torch.tensor(r, device=dev), torch.tensor(g, device=dev)
        s, p = pair_metrics(r, g)
        ssims.append(float(s))
        psnrs.append(float(p))
        if lpips_ok:
            with torch.no_grad():
                lpipss.append(float(lpips_mod.lpips(r[None], g[None])[0]))
    summary = {"SSIM": float(np.mean(ssims)), "PSNR": float(np.mean(psnrs)),
               "LPIPS": float(np.mean(lpipss)) if lpips_ok else None}
    per_view = {"SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": dict(zip(names, lpipss)) if lpips_ok else {}}
    return summary, per_view


def evaluate(model_paths: list[str], use_lpips: bool = True, *, device=None):
    """``evaluate_dir`` over every ``<scene>/test/ours_<iter>`` of each
    model path; writes ``<scene>/results.json`` and ``per_view.json``."""
    if use_lpips and not lpips_mod.available():
        print("LPIPS weights not found "
              f"({lpips_mod.default_weight_path()}); reporting LPIPS=null")
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full, per_view = {}, {}
        test_dir = os.path.join(scene_dir, "test")
        try:
            methods = sorted(os.listdir(test_dir))
        except FileNotFoundError:
            print("  no test renders found; run "
                  "python -m gslm_tpu_torch.eval.render_sets first")
            continue
        for method in methods:
            print("  method:", method)
            summary, views = evaluate_dir(os.path.join(test_dir, method),
                                          use_lpips, device=device)
            full[method] = summary
            per_view[method] = views
            for k, v in summary.items():
                print(f"    {k:>6}: {v if v is None else f'{v:.7f}'}")

        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full, f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=True)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Compute metrics over rendered sets")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--no_lpips", action="store_true")
    parser.add_argument("--platform", type=str, default="",
                        help="'' runs on the CUDA card (raises without "
                             "one), 'cpu' on the CPU")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    evaluate(args.model_paths, use_lpips=not args.no_lpips,
             device=platform_device(args.platform))


if __name__ == "__main__":
    main()
