"""Gaussian model state (gslm_tpu/models/gaussians.py) as an ``nn.Module``.

The seven parameter groups are ``nn.Parameter``s under the JAX field names
and keep the raw (pre-activation) values: exp on scaling, sigmoid on
opacity, L2-normalize on the rotation quaternion. The Gaussian count is
padded to a fixed capacity; the ``alive`` buffer (``GaussianAux.alive`` in
the JAX package) marks the live slots. ``GaussianAux`` holds the training
statistics that densification reads.

Vectors in parameter space (gradients, Adam moments, the LM solver's
iterates) are ``{group: tensor}`` dicts; the LM vector algebra below works
on them. ``with_groups`` turns such a dict back into renderable
parameters (``GaussianTensors``) without ``nn.Parameter``, which cannot
hold a forward-AD dual tensor."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.ops.knn import mean_sq_dist_3nn
from gslm_tpu_torch.ops.sh import MAX_SH_DEGREE, num_sh_coeffs, rgb2sh
from gslm_tpu_torch.struct import Struct
from gslm_tpu_torch.utils.general import (covariance_from_scaling_rotation,
                                          inverse_sigmoid, quat_normalize)

# Raw values of dead (padding) slots: transparent, tiny, at the origin.
DEAD_OPACITY_LOGIT = -12.0
DEAD_LOG_SCALE = -15.0

PARAM_GROUPS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "exposure")


class _GaussianFields:
    """What the renderer reads of a parameter set, beyond the seven groups,
    ``sh_degree`` and ``alive``."""

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_images(self) -> int:
        return self.exposure.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        """The live slot count, a 0-d int32 tensor (no host sync)."""
        return torch.sum(self.alive, dtype=torch.int32)

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_opacity(self):
        return torch.sigmoid(self.opacity)

    def get_rotation(self):
        return quat_normalize(self.rotation)

    def get_features(self):
        """(C, K+1, 3) concatenated SH coefficients (dc first)."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance(self, scaling_modifier: float = 1.0):
        """(C, 6) upper triangle of each Gaussian's 3D covariance."""
        return covariance_from_scaling_rotation(
            scaling_modifier * self.get_scaling(), self.rotation)

    def groups(self) -> dict[str, torch.Tensor]:
        return {g: getattr(self, g).detach() for g in PARAM_GROUPS}


class GaussianParams(_GaussianFields, nn.Module):
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


@dataclasses.dataclass
class GaussianTensors(_GaussianFields, Struct):
    """The seven groups as plain tensors (which may be forward-AD duals or
    record autograd), with ``sh_degree`` and ``alive``: renderable like
    ``GaussianParams``."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    exposure: torch.Tensor
    sh_degree: int
    alive: torch.Tensor


def with_groups(params, groups: dict[str, torch.Tensor]) -> GaussianTensors:
    """Renderable parameters with the seven ``groups`` of a parameter-space
    vector and the ``sh_degree`` and ``alive`` mask of ``params``."""
    return GaussianTensors(**{g: groups[g] for g in PARAM_GROUPS},
                           sh_degree=params.sh_degree, alive=params.alive)


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


def zeros_like_params(params) -> dict[str, torch.Tensor]:
    """Zeros shaped like every parameter group, keyed by group name (the
    port's form of a parameter pytree: gradients, Adam moments, LM
    iterates)."""
    return {g: torch.zeros_like(getattr(params, g)) for g in PARAM_GROUPS}


def init_aux(capacity: int, num_points: int | None = None,
             device=None) -> torch.Tensor:
    """The ``alive`` mask of ``init_aux``: the first ``num_points`` slots."""
    n = capacity if num_points is None else num_points
    return torch.arange(capacity, device=resolve_device(device)) < n


def round_capacity(n: int, multiple: int = 256) -> int:
    """Round a live count up to a lane-aligned capacity."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


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


def create_from_pcd(points: np.ndarray, colors: np.ndarray, num_images: int,
                    sh_degree: int = 3, capacity: int | None = None,
                    mean_sq_dist=None, device=None
                    ) -> tuple[GaussianParams, GaussianAux]:
    """A model from a point cloud, the 3DGS recipe: SH DC from the colours,
    zero higher-order SH, log-scales from the square root of the mean
    squared 3-NN distance, identity quaternions, opacity 0.1, identity
    per-image exposure. ``mean_sq_dist`` (P,) is computed on ``device``
    when not given (``ops/knn.mean_sq_dist_3nn``: kernel F on the card,
    one launch; the plain version on the CPU; both equal to the JAX
    package's native library bit for bit). Returns ``(params, aux)`` at
    ``capacity`` (default ``round_capacity(P)``), the first P slots
    alive."""
    dev = resolve_device(device)
    n = points.shape[0]
    k = num_sh_coeffs(min(sh_degree, MAX_SH_DEGREE)) - 1
    if capacity is None:
        capacity = round_capacity(n)

    xyz = torch.tensor(np.asarray(points, np.float32), device=dev)
    f_dc = rgb2sh(torch.tensor(np.asarray(colors, np.float32),
                               device=dev)).reshape(n, 1, 3)
    f_rest = torch.zeros((n, k, 3), device=dev)
    if mean_sq_dist is None:
        mean_sq_dist = mean_sq_dist_3nn(xyz)
    dist2 = torch.clamp(torch.as_tensor(mean_sq_dist, dtype=torch.float32,
                                        device=dev), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = torch.zeros((n, 4), device=dev)
    rots[:, 0] = 1.0
    opacities = inverse_sigmoid(0.1 * torch.ones((n, 1), device=dev))
    exposure = torch.eye(3, 4, device=dev).expand(num_images, 3, 4).clone()
    params = GaussianParams(xyz=xyz, features_dc=f_dc, features_rest=f_rest,
                            scaling=scales, rotation=rots, opacity=opacities,
                            exposure=exposure, sh_degree=sh_degree)
    return pad_to_capacity(params, capacity), GaussianAux.zeros(capacity, dev)


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


# ---------------------------------------------------------------------------
# Vector algebra over parameter-space vectors ({group: tensor} dicts): the
# LM solver's (gslm_tpu/models/gaussians.py:200-268).
# ---------------------------------------------------------------------------


def param_group_mask(**mask) -> dict[str, float]:
    """Multiplier per group: ``mask_xyz=True`` zeroes that group (masked =
    excluded from the LM step)."""
    return {g: 0.0 if mask.get(f"mask_{g}", False) else 1.0
            for g in PARAM_GROUPS}


def apply_group_mask(v: dict, mask: dict[str, float]) -> dict:
    return {g: v[g] * mask[g] for g in PARAM_GROUPS}


def apply_splat_mask(v: dict, alive: torch.Tensor) -> dict:
    """Zero the per-Gaussian rows that are not alive; exposure is
    untouched."""
    def rows(x):
        return x * alive.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return {g: v[g] if g == "exposure" else rows(v[g]) for g in PARAM_GROUPS}


def vdot(a: dict, b: dict, damp: dict[str, float] | float = 1.0
         ) -> torch.Tensor:
    """Damped inner product Σ_g damp_g ⟨a_g, b_g⟩, a 0-d tensor on the
    vectors' device (no host sync)."""
    total = torch.zeros((), dtype=torch.float32, device=a["xyz"].device)
    for g in PARAM_GROUPS:
        w = damp[g] if isinstance(damp, dict) else damp
        total = total + w * torch.dot(a[g].reshape(-1), b[g].reshape(-1))
    return total


def vdot_sharded(a: dict, b: dict, damp: dict[str, float] | float,
                 model_group) -> torch.Tensor:
    """``vdot`` of vectors whose per-Gaussian groups are this rank's shard
    of the model axis: their products are summed over ``model_group`` (a
    process group; None is one rank), ``exposure``, replicated, is counted
    once."""
    from gslm_tpu_torch.parallel.mesh import all_reduce
    local = torch.zeros((), dtype=torch.float32, device=a["xyz"].device)
    for g in PARAM_GROUPS:
        if g != "exposure":
            w = damp[g] if isinstance(damp, dict) else damp
            local = local + w * torch.dot(a[g].reshape(-1), b[g].reshape(-1))
    total = all_reduce([local], "sum", model_group)[0]
    w = damp["exposure"] if isinstance(damp, dict) else damp
    return total + w * torch.dot(a["exposure"].reshape(-1),
                                 b["exposure"].reshape(-1))


def saxpy(a, x: dict, y: dict) -> dict:
    """a*x + y over all groups (``a`` a float or a 0-d tensor)."""
    return {g: a * x[g] + y[g] for g in PARAM_GROUPS}


def scale(a, x: dict) -> dict:
    return {g: a * x[g] for g in PARAM_GROUPS}


def add(x: dict, y: dict) -> dict:
    return {g: x[g] + y[g] for g in PARAM_GROUPS}


def default_damp_matrix() -> dict[str, float]:
    """LM per-group damping defaults (reference train_jvp.py:229-235)."""
    return {"xyz": 5e2, "features_dc": 5e-2, "features_rest": 5e-2,
            "scaling": 5e-2, "rotation": 5e-2, "opacity": 5e-2,
            "exposure": 1e1}
