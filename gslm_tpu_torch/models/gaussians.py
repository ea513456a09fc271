"""Gaussian model state (gslm_tpu/models/gaussians.py) as an ``nn.Module``.

The seven parameter groups are ``nn.Parameter``s under the JAX field names
and keep the raw (pre-activation) values: exp on scaling, sigmoid on
opacity, L2-normalize on the rotation quaternion. The Gaussian count is
padded to a fixed capacity; the ``alive`` buffer (``GaussianAux.alive`` in
the JAX package) marks the live slots. ``GaussianAux`` holds the training
statistics that densification reads."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.struct import Struct

# Raw values of dead (padding) slots: transparent, tiny, at the origin.
DEAD_OPACITY_LOGIT = -12.0
DEAD_LOG_SCALE = -15.0

PARAM_GROUPS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "exposure")


class GaussianParams(nn.Module):
    """Shapes (C = capacity, K = (sh_degree+1)^2 - 1, M = #images):
    xyz (C,3), features_dc (C,1,3), features_rest (C,K,3), scaling (C,3)
    log scales, rotation (C,4) wxyz quaternions, opacity (C,1) logits,
    exposure (M,3,4) per-image affine colour transforms; ``alive`` (C,)
    bool buffer."""

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, exposure, sh_degree: int = 3, alive=None):
        super().__init__()
        self.sh_degree = sh_degree
        for name, value in zip(PARAM_GROUPS, (xyz, features_dc, features_rest,
                                              scaling, rotation, opacity,
                                              exposure)):
            setattr(self, name, nn.Parameter(value))
        if alive is None:
            alive = torch.ones(xyz.shape[0], dtype=torch.bool,
                               device=xyz.device)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_features(self):
        """(C, K+1, 3) concatenated SH coefficients (dc first)."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def groups(self) -> dict[str, torch.Tensor]:
        return {g: getattr(self, g).detach() for g in PARAM_GROUPS}


@dataclasses.dataclass
class GaussianAux(Struct):
    """Per-Gaussian training statistics (the JAX ``GaussianAux`` without
    ``alive``, which lives on ``GaussianParams``): all (C,) float32."""

    max_radii2d: torch.Tensor
    xyz_gradient_accum: torch.Tensor
    denom: torch.Tensor

    @classmethod
    def zeros(cls, capacity: int, device=None) -> "GaussianAux":
        dev = resolve_device(device)
        return cls(*(torch.zeros(capacity, device=dev) for _ in range(3)))


def zeros_like_params(params: GaussianParams) -> dict[str, torch.Tensor]:
    """Zeros shaped like every parameter group, keyed by group name (the
    port's form of a parameter pytree: gradients, Adam moments)."""
    return {g: torch.zeros_like(getattr(params, g)) for g in PARAM_GROUPS}


def init_aux(capacity: int, num_points: int | None = None,
             device=None) -> torch.Tensor:
    """The ``alive`` mask of ``init_aux``: the first ``num_points`` slots."""
    n = capacity if num_points is None else num_points
    return torch.arange(capacity, device=resolve_device(device)) < n


def pad_to_capacity(params: GaussianParams, capacity: int) -> GaussianParams:
    """Pad the per-Gaussian groups with dead slots up to ``capacity``; the
    new slots are not alive."""
    c0 = params.capacity
    if capacity < c0:
        raise ValueError(f"capacity {capacity} < current {c0}")
    extra = capacity - c0
    if extra == 0:
        return params
    g = params.groups()

    def pad(x, fill):
        return torch.cat([x, torch.full((extra,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    rot_pad = torch.zeros((extra, 4), dtype=g["rotation"].dtype,
                          device=g["rotation"].device)
    rot_pad[:, 0] = 1.0
    return GaussianParams(
        xyz=pad(g["xyz"], 0.0), features_dc=pad(g["features_dc"], 0.0),
        features_rest=pad(g["features_rest"], 0.0),
        scaling=pad(g["scaling"], DEAD_LOG_SCALE),
        rotation=torch.cat([g["rotation"], rot_pad]),
        opacity=pad(g["opacity"], DEAD_OPACITY_LOGIT),
        exposure=g["exposure"], sh_degree=params.sh_degree,
        alive=torch.cat([params.alive, params.alive.new_zeros(extra)]))


def params_from_numpy(d: dict[str, np.ndarray], sh_degree: int, alive=None,
                      device=None) -> GaussianParams:
    """Build the port's parameters from the seven JAX ``GaussianParams``
    leaves as numpy arrays (float32), and optionally the alive mask."""
    dev = resolve_device(device)
    t = {g: torch.tensor(np.asarray(d[g], np.float32), device=dev)
         for g in PARAM_GROUPS}
    if alive is not None:
        alive = torch.tensor(np.asarray(alive, bool), device=dev)
    return GaussianParams(**t, sh_degree=sh_degree, alive=alive)
