"""The system under test, ``gslm_tpu_torch``, and the benchmark's inputs in
its containers. The only module of the harness, with the mix kinds, that
imports the program; the reference and the readers never do."""

from __future__ import annotations

import sys

import numpy as np
import torch

from gslm_tpu_torch import config as cfg_mod
from gslm_tpu_torch.models.cameras import Camera, CameraBatch
from gslm_tpu_torch.models.gaussians import GaussianAux, GaussianParams
from gslm_tpu_torch.optim import init_adam
from gslm_tpu_torch.renderer import overflow_probe, render
from gslm_tpu_torch.train import make_raster_config, train_step

__all__ = ["render", "train_step", "GaussianAux", "init_adam", "params",
           "camera", "camera_batch", "raster_config", "optimization"]


def params(groups: dict, sh_degree: int) -> GaussianParams:
    """The groups as the program's parameters (sharing their storage)."""
    return GaussianParams(**groups, sh_degree=sh_degree)


def camera(cam: dict, index: int, device) -> Camera:
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return Camera(world_view=t(cam["world_view"]),
                  full_proj=t(cam["full_proj"]), campos=t(cam["campos"]),
                  tanfovx=t(np.float32(cam["tanfovx"])),
                  tanfovy=t(np.float32(cam["tanfovy"])),
                  exposure_idx=t(index, torch.int64), height=cam["height"],
                  width=cam["width"])


def camera_batch(cams: list, gt: torch.Tensor | None, device) -> CameraBatch:
    """The views as one padded batch (all of one size), ``gt`` (B, 3, H, W)
    their targets (zeros when None)."""
    B, H, W = len(cams), cams[0]["height"], cams[0]["width"]

    def stack(key, dtype=torch.float32):
        return torch.as_tensor(np.stack([np.asarray(c[key]) for c in cams]),
                               dtype=dtype, device=device)

    def plane(fill):
        return torch.full((B, 1, H, W), fill, device=device)

    return CameraBatch(
        world_view=stack("world_view"), full_proj=stack("full_proj"),
        campos=stack("campos"),
        tanfovx=torch.tensor([c["tanfovx"] for c in cams], dtype=torch.float32,
                             device=device),
        tanfovy=torch.tensor([c["tanfovy"] for c in cams], dtype=torch.float32,
                             device=device),
        exposure_idx=torch.arange(B, device=device),
        heights=torch.full((B,), H, device=device),
        widths=torch.full((B,), W, device=device),
        gt_image=(torch.zeros((B, 3, H, W), device=device) if gt is None
                  else gt),
        alpha_mask=plane(1.0), invdepth_gt=plane(0.0), depth_mask=plane(0.0),
        height=H, width=W)


def raster_config(p: GaussianParams, probe: CameraBatch, headroom: float):
    """The trainer's capacities for this scene (``make_raster_config``),
    doubled (``RasterConfig.grow``, as the trainer's overflow retry does)
    until the AABB and live records of every probed view fit with
    ``headroom`` to spare; the counts and capacities go to standard
    error."""
    H, W = probe.height, probe.width
    rcfg = make_raster_config(cfg_mod.TpuParams(), cfg_mod.PipelineParams(),
                              H, W, p.capacity)
    n_aabb = n_live = 0
    for i in range(probe.batch_size):
        got = overflow_probe(p, probe.take(slice(i, i + 1)), config=rcfg)
        n_aabb = max(n_aabb, int(got["n_aabb"]))
        n_live = max(n_live, int(got["n_live"]))
    while (rcfg.dup_capacity < headroom * n_aabb
           or rcfg.eff_capacity() < headroom * n_live):
        rcfg = rcfg.grow()
    print(f"records of the {probe.batch_size} probed views: AABB at most "
          f"{n_aabb}, live at most {n_live}; capacities {rcfg.dup_capacity} "
          f"and {rcfg.eff_capacity()}", file=sys.stderr)
    return rcfg


def optimization(overrides: dict) -> cfg_mod.OptimizationParams:
    return cfg_mod.OptimizationParams(**overrides)

