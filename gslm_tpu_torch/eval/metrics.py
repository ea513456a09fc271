"""Quality metrics over rendered sets: SSIM / PSNR (gslm_tpu/eval/metrics.py).

LPIPS is not ported yet: it is reported as null, as the JAX package
reports it without its weights."""

from __future__ import annotations

import os

import numpy as np
import torch

from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.ops.ssim import ssim
from gslm_tpu_torch.utils.image import psnr


def read_images(renders_dir: str, gt_dir: str):
    """Paired (3, H, W) float32 images in [0, 1] of two directories."""
    from PIL import Image     # not needed on the render path
    names = sorted(os.listdir(renders_dir))
    renders, gts = [], []
    for name in names:
        for d, acc in ((renders_dir, renders), (gt_dir, gts)):
            img = np.asarray(Image.open(os.path.join(d, name)),
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
    (with a printed note when ``use_lpips`` asks for it)."""
    dev = resolve_device(device)
    if use_lpips:
        print("LPIPS is not ported to gslm_tpu_torch yet: reporting LPIPS: "
              "null")
    names, renders, gts = read_images(os.path.join(method_dir, "renders"),
                                      os.path.join(method_dir, "gt"))
    ssims, psnrs = [], []
    for r, g in zip(renders, gts):
        s, p = pair_metrics(torch.tensor(r, device=dev),
                            torch.tensor(g, device=dev))
        ssims.append(float(s))
        psnrs.append(float(p))
    summary = {"SSIM": float(np.mean(ssims)), "PSNR": float(np.mean(psnrs)),
               "LPIPS": None}
    per_view = {"SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)), "LPIPS": {}}
    return summary, per_view
