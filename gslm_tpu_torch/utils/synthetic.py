"""Synthetic scenes and cameras (gslm_tpu/utils/synthetic.py).

Every draw comes from the caller's ``numpy.random.Generator`` in the JAX
package's order, so the same seed gives the same numbers in both
packages."""

from __future__ import annotations

import math

import numpy as np
import torch

from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.models.cameras import (CameraBatch, CameraMeta,
                                           batch_from_metas)
from gslm_tpu_torch.models.gaussians import (GaussianParams, init_aux,
                                             pad_to_capacity)
from gslm_tpu_torch.ops.sh import num_sh_coeffs
from gslm_tpu_torch.utils.graphics import focal2fov


def make_camera(height=64, width=64, fov_deg=60.0, radius=4.0, angle=0.0,
                exposure_idx=0) -> CameraMeta:
    """Camera on a circle around the origin, looking at the origin."""
    fov = math.radians(fov_deg)
    c = np.array([radius * math.sin(angle), 0.0, -radius * math.cos(angle)])
    z = -c / np.linalg.norm(c)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=0)
    T = -R_wc @ c
    fovy = focal2fov(width / (2 * math.tan(fov / 2)), height)
    return CameraMeta(uid=exposure_idx, colmap_id=exposure_idx, R=R_wc.T, T=T,
                      fovx=fov, fovy=fovy, width=width, height=height,
                      image_name=f"cam{exposure_idx}",
                      exposure_idx=exposure_idx)


def random_gaussians(rng: np.random.Generator, n=128, capacity=None,
                     sh_degree=3, num_images=4, spread=1.0,
                     scale_range=(-3.5, -2.0), device=None) -> GaussianParams:
    """Random cloud of n Gaussians (padded to ``capacity`` if given, the
    padding not alive). The JAX version returns (params, aux); here the
    alive mask lives on the params."""
    dev = resolve_device(device)
    k = num_sh_coeffs(sh_degree) - 1

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    params = GaussianParams(
        xyz=f32(rng.uniform(-spread, spread, (n, 3))),
        features_dc=f32(rng.normal(0, 0.5, (n, 1, 3))),
        features_rest=f32(rng.normal(0, 0.05, (n, k, 3))),
        scaling=f32(rng.uniform(*scale_range, (n, 3))),
        rotation=f32(rng.normal(0, 1, (n, 4))),
        opacity=f32(rng.uniform(-1.0, 2.0, (n, 1))),
        exposure=f32(np.broadcast_to(np.eye(3, 4), (num_images, 3, 4))),
        sh_degree=sh_degree, alive=init_aux(n, n, device=dev))
    if capacity is not None and capacity > n:
        params = pad_to_capacity(params, capacity)
    return params


def clustered_cloud(rng: np.random.Generator, n: int, clusters: int = 8,
                    spread: float = 0.02, outliers: float = 0.01,
                    outlier_spread: float = 100.0) -> np.ndarray:
    """(n, 3) float32 points: ``clusters`` normal clusters of std
    ``spread`` around centres uniform in [-1, 1]^3, and the first
    ``outliers`` of the points normal about the origin at
    ``outlier_spread`` times the clusters' std. A cloud whose bounding box
    the outliers stretch far past its mass: the 3-NN's hard case. No JAX
    counterpart."""
    centres = rng.uniform(-1.0, 1.0, (clusters, 3))
    pts = centres[rng.integers(0, clusters, n)] \
        + rng.normal(0.0, spread, (n, 3))
    m = int(n * outliers)
    pts[:m] = rng.normal(0.0, outlier_spread * spread, (m, 3))
    return pts.astype(np.float32)


def ring_camera_batch(n_views: int, height: int, width: int, radius=4.0,
                      gt_seed: int | None = 0, device=None) -> CameraBatch:
    """Cameras on a ring, with random ground-truth images (uniform in [0,1)
    from ``gt_seed``) unless ``gt_seed`` is None."""
    metas = [make_camera(height=height, width=width,
                         angle=2 * math.pi * i / max(n_views, 1),
                         radius=radius, exposure_idx=i)
             for i in range(n_views)]
    batch = batch_from_metas(metas, device=device)
    if gt_seed is not None:
        rng = np.random.default_rng(gt_seed)
        gt = rng.uniform(0, 1, tuple(batch.gt_image.shape)).astype(np.float32)
        batch = batch.replace(gt_image=torch.tensor(gt, device=batch.gt_image.device))
    return batch
