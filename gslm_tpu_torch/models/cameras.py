"""Camera containers (gslm_tpu/models/cameras.py).

- ``CameraMeta``: host-side per-view record (numpy matrices, image).
- ``Camera`` / ``CameraBatch``: tensors on the device, ready for the
  renderer. A batch pads every view to a common (H, W) canvas and records
  each view's true extent."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.struct import Struct
from gslm_tpu_torch.utils.graphics import projection_matrix, world_to_view

Z_NEAR = 0.01
Z_FAR = 100.0


@dataclasses.dataclass
class CameraMeta(Struct):
    """Host-side view description."""

    uid: int
    colmap_id: int
    R: np.ndarray            # (3,3) cam-to-world rotation (COLMAP convention)
    T: np.ndarray            # (3,) world-to-cam translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_name: str
    image_path: str | None = None
    depth_path: str | None = None
    depth_params: dict | None = None
    is_test: bool = False
    # filled by Scene when images are loaded:
    image: np.ndarray | None = None        # (3, H, W) float32 in [0,1]
    alpha_mask: np.ndarray | None = None   # (1, H, W) float32
    invdepthmap: np.ndarray | None = None  # (1, H, W) float32
    depth_reliable: bool = False
    depth_mask: np.ndarray | None = None
    exposure_idx: int = 0
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    @property
    def world_view(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale)

    @property
    def projection(self) -> np.ndarray:
        return projection_matrix(Z_NEAR, Z_FAR, self.fovx, self.fovy)

    @property
    def full_proj(self) -> np.ndarray:
        return (self.projection @ self.world_view).astype(np.float32)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view)[:3, 3].astype(np.float32)


@dataclasses.dataclass
class Camera(Struct):
    """One view on the device: everything the rasterizer needs."""

    world_view: torch.Tensor    # (4, 4)
    full_proj: torch.Tensor     # (4, 4)
    campos: torch.Tensor        # (3,)
    tanfovx: torch.Tensor       # () float32
    tanfovy: torch.Tensor       # () float32
    exposure_idx: torch.Tensor  # () int64
    height: int
    width: int


@dataclasses.dataclass
class CameraBatch(Struct):
    """B stacked views on a common padded (height, width) canvas."""

    world_view: torch.Tensor    # (B, 4, 4)
    full_proj: torch.Tensor     # (B, 4, 4)
    campos: torch.Tensor        # (B, 3)
    tanfovx: torch.Tensor       # (B,)
    tanfovy: torch.Tensor       # (B,)
    exposure_idx: torch.Tensor  # (B,) int64
    heights: torch.Tensor       # (B,) true extents
    widths: torch.Tensor        # (B,)
    gt_image: torch.Tensor      # (B, 3, H, W) padded ground truth
    alpha_mask: torch.Tensor    # (B, 1, H, W); all ones when unused
    invdepth_gt: torch.Tensor   # (B, 1, H, W) monocular inverse depth (0 if none)
    depth_mask: torch.Tensor    # (B, 1, H, W) depth validity (0 if none)
    height: int
    width: int

    @property
    def batch_size(self) -> int:
        return self.world_view.shape[0]

    def pixel_valid(self) -> torch.Tensor:
        """(B, 1, H, W) float mask of the pixels inside each view's extent."""
        dev = self.heights.device
        ys = torch.arange(self.height, device=dev)[None, :, None]
        xs = torch.arange(self.width, device=dev)[None, None, :]
        valid = ((ys < self.heights[:, None, None])
                 & (xs < self.widths[:, None, None]))
        return valid[:, None].to(torch.float32)

    def take(self, idx) -> "CameraBatch":
        """The views ``idx`` (a slice, a list or an index tensor) as a batch
        on the same canvas."""
        if isinstance(idx, list):
            idx = torch.tensor(idx, dtype=torch.long,
                               device=self.world_view.device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def view(self, i: int) -> Camera:
        return Camera(world_view=self.world_view[i], full_proj=self.full_proj[i],
                      campos=self.campos[i], tanfovx=self.tanfovx[i],
                      tanfovy=self.tanfovy[i], exposure_idx=self.exposure_idx[i],
                      height=self.height, width=self.width)


def meta_from_arrays(R, T, fovx, fovy, width, height,
                     exposure_idx=0) -> CameraMeta:
    """A ``CameraMeta`` from the numbers a JAX ``CameraMeta`` holds."""
    return CameraMeta(uid=exposure_idx, colmap_id=exposure_idx,
                      R=np.asarray(R), T=np.asarray(T), fovx=float(fovx),
                      fovy=float(fovy), width=int(width), height=int(height),
                      image_name=f"cam{exposure_idx}",
                      exposure_idx=exposure_idx)


def camera_from_meta(meta: CameraMeta, device=None) -> Camera:
    dev = resolve_device(device)
    return Camera(
        world_view=torch.tensor(meta.world_view, device=dev),
        full_proj=torch.tensor(meta.full_proj, device=dev),
        campos=torch.tensor(meta.camera_center, device=dev),
        tanfovx=torch.tensor(math.tan(meta.fovx * 0.5), dtype=torch.float32,
                             device=dev),
        tanfovy=torch.tensor(math.tan(meta.fovy * 0.5), dtype=torch.float32,
                             device=dev),
        exposure_idx=torch.tensor(meta.exposure_idx, device=dev),
        height=meta.height, width=meta.width)


def camera_from_arrays(R, T, fovx, fovy, width, height, exposure_idx=0,
                       device=None) -> Camera:
    """A ``Camera`` from the numpy ``R, T, fovx, fovy, width, height`` that
    a JAX ``CameraMeta`` holds."""
    return camera_from_meta(meta_from_arrays(R, T, fovx, fovy, width, height,
                                             exposure_idx), device=device)


def batch_from_metas(metas: list[CameraMeta],
                     pad_hw: tuple[int, int] | None = None,
                     device=None) -> CameraBatch:
    """Stack host camera records into a padded device batch."""
    dev = resolve_device(device)
    b = len(metas)
    max_h = max(m.height for m in metas)
    max_w = max(m.width for m in metas)
    if pad_hw is not None:
        max_h = max(max_h, pad_hw[0])
        max_w = max(max_w, pad_hw[1])
    gt = np.zeros((b, 3, max_h, max_w), dtype=np.float32)
    am = np.ones((b, 1, max_h, max_w), dtype=np.float32)
    dg = np.zeros((b, 1, max_h, max_w), dtype=np.float32)
    dm = np.zeros((b, 1, max_h, max_w), dtype=np.float32)
    for i, m in enumerate(metas):
        if m.image is not None:
            gt[i, :, :m.height, :m.width] = m.image
        if m.alpha_mask is not None:
            am[i, :, :m.height, :m.width] = m.alpha_mask
        if m.invdepthmap is not None and m.depth_reliable:
            dg[i, :, :m.height, :m.width] = m.invdepthmap
            if m.depth_mask is not None:
                dm[i, :, :m.height, :m.width] = m.depth_mask

    def t(x, dtype=None):
        return torch.tensor(np.asarray(x, dtype), device=dev)

    return CameraBatch(
        world_view=t(np.stack([m.world_view for m in metas])),
        full_proj=t(np.stack([m.full_proj for m in metas])),
        campos=t(np.stack([m.camera_center for m in metas])),
        tanfovx=t([math.tan(m.fovx * 0.5) for m in metas], np.float32),
        tanfovy=t([math.tan(m.fovy * 0.5) for m in metas], np.float32),
        exposure_idx=t([m.exposure_idx for m in metas], np.int64),
        heights=t([m.height for m in metas], np.int64),
        widths=t([m.width for m in metas], np.int64),
        gt_image=t(gt), alpha_mask=t(am), invdepth_gt=t(dg),
        depth_mask=t(dm), height=max_h, width=max_w)
