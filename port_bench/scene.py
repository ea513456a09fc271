"""The benchmark's inputs, made from ``--seed``: a synthetic Gaussian scene
on the device, cameras on a ring and an orbit (numpy matrices), and smooth
target images. Both the program and the reference take what these
functions return; the program gets it in its containers (``program.py``).

The scene law is the port's ``utils/synthetic.random_gaussians`` with
bench.py's headline settings (spread 1.5, log-scales in [-5.5, -3.5],
opacity logits in [-1, 2], DC colours N(0, 0.5), higher SH N(0, 0.05),
rotations N(0, 1)), drawn with a ``torch.Generator`` on the device in one
call per group. The cameras follow ``utils/synthetic.make_camera`` (a
camera on a circle about the origin, looking at it) with an elevation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Z_NEAR, Z_FAR = 0.01, 100.0
SH_REST = 15            # SH degree 3: 16 coefficients, DC apart


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds from the run's seed (any integer)."""
    ss = np.random.SeedSequence(seed % (1 << 64))
    return [int(s) for s in ss.generate_state(n, np.uint64) >> np.uint64(1)]


def gaussians(cfg: dict, seed: int, device) -> dict:
    """The scene's seven raw parameter groups, float32 on ``device``."""
    law = cfg["scene_law"]
    n, m = cfg["num_gaussians"], cfg["train_views"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    return {
        "xyz": uniform((n, 3), -law["spread"], law["spread"]),
        "features_dc": normal((n, 1, 3), law["dc_std"]),
        "features_rest": normal((n, SH_REST, 3), law["rest_std"]),
        "scaling": uniform((n, 3), *law["log_scale"]),
        "rotation": normal((n, 4), 1.0),
        "opacity": uniform((n, 1), *law["opacity_logit"]),
        "exposure": torch.eye(3, 4, device=device).expand(m, 3, 4).clone(),
    }


def look_at(radius: float, azimuth: float, elevation: float, fov_deg: float,
            height: int, width: int) -> dict:
    """One camera: world→view and full projection (4x4 float32), centre,
    tan of the half fields of view, size."""
    fovx = math.radians(fov_deg)
    c = radius * np.array([math.sin(azimuth) * math.cos(elevation),
                           math.sin(elevation),
                           -math.cos(azimuth) * math.cos(elevation)])
    z = -c / np.linalg.norm(c)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    r_wc = np.stack([x, y, z], axis=0)
    wv = np.eye(4)
    wv[:3, :3] = r_wc
    wv[:3, 3] = -r_wc @ c
    wv = wv.astype(np.float32)
    fovy = 2 * math.atan(height / (2 * (width / (2 * math.tan(fovx / 2)))))
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0 / tx
    proj[1, 1] = 1.0 / ty
    proj[2, 2] = Z_FAR / (Z_FAR - Z_NEAR)
    proj[2, 3] = -(Z_FAR * Z_NEAR) / (Z_FAR - Z_NEAR)
    proj[3, 2] = 1.0
    return {"world_view": wv, "full_proj": (proj @ wv).astype(np.float32),
            "campos": np.linalg.inv(wv)[:3, 3].astype(np.float32),
            "tanfovx": tx, "tanfovy": ty, "height": height, "width": width}


def train_cameras(cfg: dict, seed: int) -> list[dict]:
    """The training views: a ring at the configured radius, view i at
    azimuth 2πi/n and a seeded elevation."""
    law = cfg["camera_law"]
    n = cfg["train_views"]
    rng = np.random.default_rng(seed)
    elev = rng.uniform(-law["elevation"], law["elevation"], n)
    return [look_at(law["radius"], 2 * math.pi * i / n, float(elev[i]),
                    law["fov_deg"], cfg["height"], cfg["width"])
            for i in range(n)]


def orbit_cameras(cfg: dict, orbit: dict) -> list[dict]:
    """A viewer's orbit: ``poses`` cameras at a fixed radius, the
    elevation swinging about ``elevation`` by ``swing`` twice a turn."""
    n = orbit["poses"]
    return [look_at(orbit["radius"], 2 * math.pi * i / n,
                    orbit["elevation"]
                    + orbit["swing"] * math.sin(4 * math.pi * i / n),
                    cfg["camera_law"]["fov_deg"], cfg["height"], cfg["width"])
            for i in range(n)]


def extent(cams: list[dict]) -> float:
    """3DGS's ``cameras_extent``: 1.1 times the largest distance of a
    camera centre from their mean (``getNerfppNorm``)."""
    centres = np.stack([c["campos"] for c in cams]).astype(np.float64)
    return float(1.1 * np.linalg.norm(centres - centres.mean(0),
                                      axis=1).max())


def targets(cfg: dict, seed: int, device, n_views: int) -> torch.Tensor:
    """(n_views, 3, H, W) smooth images in [0, 1]: per view and channel,
    the mean of ``waves`` plane waves of 0.5 to 4 cycles across the image
    at seeded directions and phases, mapped from [-1, 1]."""
    k = cfg["target_law"]["waves"]
    H, W = cfg["height"], cfg["width"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(lo, hi):
        return torch.rand((n_views, 3, k), generator=gen,
                          device=device) * (hi - lo) + lo

    freq = draw(0.5, 4.0)
    angle = draw(0.0, 2 * math.pi)
    phase = draw(0.0, 2 * math.pi)
    ys = torch.linspace(0.0, 1.0, H, device=device)[:, None]
    xs = torch.linspace(0.0, 1.0, W, device=device)[None, :]
    out = torch.zeros((n_views, 3, H, W), device=device)
    for j in range(k):
        fx = (freq[..., j] * torch.cos(angle[..., j]))[..., None, None]
        fy = (freq[..., j] * torch.sin(angle[..., j]))[..., None, None]
        out += torch.sin(2 * math.pi * (fx * xs + fy * ys)
                         + phase[..., j, None, None])
    return out.div_(2.0 * k).add_(0.5)
