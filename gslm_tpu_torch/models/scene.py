"""Scene: dataset assembly, image loading, model initialisation, save and
load (gslm_tpu/models/scene.py).

Resolution selection, alpha masks, the train/test exposure half-masks,
the nerf++ extent, cameras.json, and the PLY + exposure.json export.
Pixels stay host numpy in ``CameraMeta``; the model lives on ``device``.
Images are read and resized by the port's codec (``data/png.py``), which
reproduces Pillow's default resize. Monocular inverse-depth maps (16-bit
PNG) are read in OpenCV's channel order (``read_png_cv2``) and resized as
``cv2.resize`` does (``data/resample.resize_linear``)."""

from __future__ import annotations

import dataclasses
import json
import os
import random

import numpy as np
import torch

from gslm_tpu_torch.data.ply import (load_gaussians_ply, save_gaussians_ply,
                                     store_point_cloud)
from gslm_tpu_torch.data.png import load_image, read_png_cv2, resize_uint8
from gslm_tpu_torch.data.readers import load_scene_info
from gslm_tpu_torch.data.resample import resize_linear
from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.models.cameras import CameraMeta
from gslm_tpu_torch.models.gaussians import (GaussianAux, GaussianParams,
                                             create_from_pcd, pad_to_capacity,
                                             round_capacity)
from gslm_tpu_torch.utils.graphics import fov2focal

_WARNED = False


def resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0) -> tuple[int, int]:
    """Target (w, h): -1 caps the width at 1600; 1/2/4/8 are divisors;
    any other value is an explicit target width."""
    global _WARNED
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        if orig_w > 1600:
            if not _WARNED:
                print("[ INFO ] Encountered quite large input images "
                      "(>1.6K pixels width), rescaling to 1.6K.")
                _WARNED = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera_pixels(meta: CameraMeta, resolution: int,
                       resolution_scale: float = 1.0,
                       train_test_exp: bool = False,
                       is_test_dataset: bool = False,
                       is_nerf_synthetic: bool = False) -> CameraMeta:
    """``meta`` with its image and alpha mask at the selected resolution,
    and, where its depth file exists, the inverse-depth map, its mask and
    reliability: the map over 512 (NeRF-synthetic) or 2^16, resized,
    negatives clamped to 0; a view whose ``depth_params`` scale lies
    outside [0.2, 5] × the median scale is unreliable (mask zero); the
    scale and offset applied where the scale is positive. Of a
    multi-channel map the first channel in OpenCV's order is taken: blue
    of RGB(A), grey of grey + alpha."""
    if meta.image is not None and meta.alpha_mask is not None:
        # the Blender reader composited full-resolution RGBA; resize if needed
        rgb = np.asarray(meta.image)
        alpha = np.asarray(meta.alpha_mask)
        w, h = resolve_resolution(meta.width, meta.height, resolution,
                                  resolution_scale)
        if (h, w) != rgb.shape[1:]:
            img = ((np.concatenate([rgb, alpha], 0).transpose(1, 2, 0) * 255)
                   .astype(np.uint8))
            arr = (np.asarray(resize_uint8(img, (w, h)), dtype=np.float32)
                   .transpose(2, 0, 1) / 255.0)
            rgb, alpha = arr[:3], arr[3:4]
    else:
        img = load_image(meta.image_path)
        w, h = resolve_resolution(img.shape[1], img.shape[0], resolution,
                                  resolution_scale)
        arr = np.asarray(resize_uint8(img, (w, h)), dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, -1)
        arr = arr.transpose(2, 0, 1)
        rgb = arr[:3]
        alpha = arr[3:4] if arr.shape[0] == 4 else np.ones((1, h, w), np.float32)

    if train_test_exp and meta.is_test:
        alpha = alpha.copy()
        if is_test_dataset:
            alpha[..., :alpha.shape[-1] // 2] = 0   # eval on the right half
        else:
            alpha[..., alpha.shape[-1] // 2:] = 0   # fit exposure on the left

    invdepth = None
    depth_mask = None
    depth_reliable = False
    if meta.depth_path and os.path.exists(meta.depth_path):
        raw = read_png_cv2(meta.depth_path)
        if raw.ndim != 2:
            # the JAX package picks the channel last; every step before it
            # works per channel, so picking it first gives the same map
            raw = raw[..., 0]
        divisor = 512.0 if is_nerf_synthetic else float(2 ** 16)
        invdepth = resize_linear(raw.astype(np.float32) / divisor, (w, h))
        invdepth[invdepth < 0] = 0
        depth_mask = np.ones((1, h, w), np.float32)
        depth_reliable = True
        dp = meta.depth_params
        if dp is not None:
            if (dp["scale"] < 0.2 * dp["med_scale"]
                    or dp["scale"] > 5 * dp["med_scale"]):
                depth_reliable = False
                depth_mask *= 0
            if dp["scale"] > 0:
                invdepth = invdepth * dp["scale"] + dp["offset"]
        invdepth = invdepth[None]

    return dataclasses.replace(
        meta, image=np.clip(rgb, 0.0, 1.0), alpha_mask=alpha, width=w,
        height=h, invdepthmap=invdepth, depth_mask=depth_mask,
        depth_reliable=depth_reliable)


def camera_to_json(idx: int, meta: CameraMeta) -> dict:
    """A cameras.json entry."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = meta.R.T
    rt[:3, 3] = meta.T
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    return {"id": idx, "img_name": meta.image_name, "width": meta.width,
            "height": meta.height, "position": c2w[:3, 3].tolist(),
            "rotation": [r.tolist() for r in c2w[:3, :3]],
            "fy": fov2focal(meta.fovy, meta.height),
            "fx": fov2focal(meta.fovx, meta.width)}


class Scene:
    """Host-side scene container: the ``CameraMeta`` lists with their
    pixels, and the Gaussian model (``params``, with its ``alive`` mask,
    and ``aux``) on ``device``. ``shuffle`` permutes the train and test
    cameras with ``rng`` (default ``random.Random(0)``)."""

    def __init__(self, source_path: str, model_path: str, *, images: str = "images",
                 depths: str = "", resolution: int = -1, white_background: bool = False,
                 eval_split: bool = False, train_test_exp: bool = False,
                 sh_degree: int = 3, load_iteration: int | None = None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 capacity: int | None = None, device=None,
                 rng: random.Random | None = None):
        dev = resolve_device(device)
        self.model_path = model_path
        self.train_test_exp = train_test_exp
        self.loaded_iter = None

        if load_iteration is not None:
            if load_iteration == -1:
                pc_dir = os.path.join(model_path, "point_cloud")
                iters = [int(d.split("_")[-1]) for d in os.listdir(pc_dir)
                         if d.startswith("iteration_")]
                load_iteration = max(iters)
            self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {load_iteration}")

        if os.path.exists(os.path.join(source_path, "sparse")):
            info = load_scene_info(source_path, images=images, depths=depths,
                                   eval_split=eval_split,
                                   train_test_exp=train_test_exp)
        else:
            info = load_scene_info(source_path, white_background=white_background,
                                   depths=depths, eval_split=eval_split)
        self.scene_info = info
        self.white_background = white_background

        if not self.loaded_iter and model_path:
            os.makedirs(model_path, exist_ok=True)
            store_point_cloud(os.path.join(model_path, "input.ply"),
                              np.asarray(info.points),
                              np.asarray(info.colors) * 255)
            cam_json = [camera_to_json(i, c) for i, c in
                        enumerate(info.train_cameras + info.test_cameras)]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            rng = random.Random(0) if rng is None else rng
            rng.shuffle(info.train_cameras)
            rng.shuffle(info.test_cameras)

        self.cameras_extent = float(info.nerf_normalization["radius"])

        self.train_cameras: dict[float, list[CameraMeta]] = {}
        self.test_cameras: dict[float, list[CameraMeta]] = {}
        for scale in resolution_scales:
            print(f"Loading Training Cameras at scale {scale}")
            self.train_cameras[scale] = [
                load_camera_pixels(c, resolution, scale, train_test_exp, False,
                                   info.is_nerf_synthetic)
                for c in info.train_cameras]
            print(f"Loading Test Cameras at scale {scale}")
            self.test_cameras[scale] = [
                load_camera_pixels(c, resolution, scale, train_test_exp, True,
                                   info.is_nerf_synthetic)
                for c in info.test_cameras]

        # exposure indices follow the train-camera order
        self.exposure_mapping = {c.image_name: i for i, c in
                                 enumerate(self.train_cameras[resolution_scales[0]])}
        for scale in resolution_scales:
            for cams in (self.train_cameras[scale], self.test_cameras[scale]):
                for c in cams:
                    c.exposure_idx = self.exposure_mapping.get(c.image_name, 0)

        num_images = max(1, len(self.exposure_mapping))
        if self.loaded_iter:
            ply = os.path.join(model_path, "point_cloud",
                               f"iteration_{self.loaded_iter}", "point_cloud.ply")
            self.params, self.aux = load_gaussians(
                ply, sh_degree=sh_degree, num_images=num_images,
                capacity=capacity, device=dev)
            exposure_file = os.path.join(model_path, "exposure.json")
            if train_test_exp and os.path.exists(exposure_file):
                with open(exposure_file) as f:
                    exposures = json.load(f)
                expo = np.stack([np.array(exposures[name], np.float32)
                                 for name in self.exposure_mapping], axis=0)
                with torch.no_grad():
                    self.params.exposure.copy_(torch.from_numpy(expo))
        else:
            self.params, self.aux = create_from_pcd(
                np.asarray(info.points), np.asarray(info.colors),
                num_images=num_images, sh_degree=sh_degree, capacity=capacity,
                device=dev)

    def get_train_cameras(self, scale: float = 1.0) -> list[CameraMeta]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> list[CameraMeta]:
        return self.test_cameras[scale]

    def save(self, iteration: int, params: GaussianParams | None = None):
        """Write point_cloud/iteration_<n>/point_cloud.ply (the alive rows
        only) and exposure.json."""
        params = self.params if params is None else params
        out = os.path.join(self.model_path, "point_cloud",
                           f"iteration_{iteration}")
        alive = params.alive.cpu().numpy()

        def rows(g):
            return getattr(params, g).detach().cpu().numpy()[alive]

        save_gaussians_ply(
            os.path.join(out, "point_cloud.ply"), rows("xyz"),
            rows("features_dc"), rows("features_rest"), rows("opacity"),
            rows("scaling"), rows("rotation"))
        exposure = params.exposure.detach().cpu().numpy()
        exposures = {name: exposure[idx].tolist()
                     for name, idx in self.exposure_mapping.items()}
        with open(os.path.join(self.model_path, "exposure.json"), "w") as f:
            json.dump(exposures, f, indent=2)


def load_gaussians(ply_path: str, sh_degree: int = 3, num_images: int = 1,
                   capacity: int | None = None, device=None
                   ) -> tuple[GaussianParams, GaussianAux]:
    """PLY → ``(params, aux)`` on ``device``, padded to ``capacity``
    (default ``round_capacity`` of the rows), the loaded rows alive."""
    dev = resolve_device(device)
    d = load_gaussians_ply(ply_path, max_sh_degree=sh_degree)
    n = d["xyz"].shape[0]
    t = {k: torch.tensor(v, device=dev) for k, v in d.items()}
    params = GaussianParams(
        **t, exposure=torch.eye(3, 4, device=dev).expand(
            num_images, 3, 4).clone(), sh_degree=sh_degree)
    capacity = capacity or round_capacity(n)
    return (pad_to_capacity(params, capacity),
            GaussianAux.zeros(capacity, dev))
