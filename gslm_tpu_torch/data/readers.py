"""Scene readers, COLMAP and Blender (NeRF-synthetic) → ``SceneInfo``
(gslm_tpu/data/readers.py): host-side ``CameraMeta`` records, the point
cloud and the nerf++ normalisation. The Blender reader takes its RGBA
through the port's image codec (``data/png.py``)."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from gslm_tpu_torch.data import colmap
from gslm_tpu_torch.data.ply import fetch_point_cloud, store_point_cloud
from gslm_tpu_torch.data.png import load_image
from gslm_tpu_torch.models.cameras import CameraMeta
from gslm_tpu_torch.ops.sh import sh2rgb
from gslm_tpu_torch.utils.graphics import (focal2fov, fov2focal, qvec2rotmat,
                                           world_to_view)


@dataclasses.dataclass
class SceneInfo:
    points: np.ndarray          # (N, 3)
    colors: np.ndarray          # (N, 3) in [0, 1]
    normals: np.ndarray
    train_cameras: list[CameraMeta]
    test_cameras: list[CameraMeta]
    nerf_normalization: dict
    ply_path: str
    is_nerf_synthetic: bool


def get_nerfpp_norm(cams: list[CameraMeta]) -> dict:
    """Scene translate/radius from camera centers (dataset_readers.py:48-69)."""
    centers = np.stack([np.linalg.inv(world_to_view(c.R, c.T))[:3, 3]
                        for c in cams], axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.max(np.linalg.norm(centers - avg, axis=1))
    return {"translate": -avg, "radius": diagonal * 1.1}


def read_colmap_scene(path: str, images: str = "images", depths: str = "",
                      eval_split: bool = False, train_test_exp: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    # depth params with median-scale normalization (dataset_readers.py:157-177)
    depths_params = None
    if depths:
        with open(os.path.join(sparse, "depth_params.json")) as f:
            depths_params = json.load(f)
        scales = np.array([depths_params[k]["scale"] for k in depths_params])
        med_scale = np.median(scales[scales > 0]) if (scales > 0).sum() else 0
        for k in depths_params:
            depths_params[k]["med_scale"] = med_scale

    # test split: every llffhold-th name, sorted (dataset_readers.py:179-191)
    if eval_split:
        names = sorted(im.name for im in extr.values())
        test_names = set(n for i, n in enumerate(names) if i % llffhold == 0)
    else:
        test_names = set()

    cams = []
    for im in extr.values():
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[0], cam.height)
        elif cam.model == "PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[1], cam.height)
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE) supported, got " + cam.model)

        stem = im.name[:-(len(im.name.split(".")[-1]) + 1)]
        dp = depths_params.get(stem) if depths_params else None
        cams.append(CameraMeta(
            uid=cam.id, colmap_id=im.id, R=qvec2rotmat(im.qvec).T,
            T=np.array(im.tvec), fovx=fovx, fovy=fovy,
            width=cam.width, height=cam.height, image_name=im.name,
            image_path=os.path.join(path, images, im.name),
            depth_path=(os.path.join(path, depths, f"{stem}.png")
                        if depths else None),
            depth_params=dp, is_test=im.name in test_names))
    cams.sort(key=lambda c: c.image_name)

    train = [c for c in cams if train_test_exp or not c.is_test]
    test = [c for c in cams if c.is_test]

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        store_point_cloud(ply_path, xyz, rgb)
    points, colors, normals = fetch_point_cloud(ply_path)

    return SceneInfo(points=points, colors=colors, normals=normals,
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path, is_nerf_synthetic=False)


def _rgba(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → (H, W, 4), as Pillow's
    ``convert("RGBA")`` does for grey, grey + alpha, RGB and RGBA."""
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[2]
    grey = img[..., :1].repeat(3, axis=2)
    opaque = np.full(img.shape[:2] + (1,), 255, np.uint8)
    parts = {1: (grey, opaque), 2: (grey, img[..., 1:]),
             3: (img, opaque), 4: (img,)}[c]
    return np.concatenate(parts, axis=2)


def _read_transforms(path, fname, white_background, is_test, depths_folder,
                     extension=".png"):
    cams = []
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if not os.path.splitext(file_path)[1]:
            file_path = file_path + extension
        image_path = os.path.join(path, file_path)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1          # OpenGL/Blender → COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        im = _rgba(load_image(image_path)) / 255.0
        bg = np.ones(3) if white_background else np.zeros(3)
        rgb = im[:, :, :3] * im[:, :, 3:4] + bg * (1 - im[:, :, 3:4])

        name = Path(file_path).stem
        h, w = im.shape[:2]
        cams.append(CameraMeta(
            uid=idx, colmap_id=idx, R=R, T=T, fovx=fovx,
            fovy=focal2fov(fov2focal(fovx, w), h), width=w, height=h,
            image_name=name, image_path=image_path,
            depth_path=(os.path.join(depths_folder, f"{name}.png")
                        if depths_folder else None),
            is_test=is_test,
            image=rgb.transpose(2, 0, 1).astype(np.float32),
            alpha_mask=im[:, :, 3][None].astype(np.float32)))
    return cams


def read_blender_scene(path: str, white_background: bool = False,
                       depths: str = "", eval_split: bool = False,
                       extension: str = ".png") -> SceneInfo:
    depths_folder = os.path.join(path, depths) if depths else ""
    train = _read_transforms(path, "transforms_train.json", white_background,
                             False, depths_folder, extension)
    test = _read_transforms(path, "transforms_test.json", white_background,
                            True, depths_folder, extension) \
        if os.path.exists(os.path.join(path, "transforms_test.json")) else []
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        store_point_cloud(ply_path, xyz, np.asarray(sh2rgb(shs)) * 255)
    points, colors, normals = fetch_point_cloud(ply_path)

    return SceneInfo(points=points, colors=colors, normals=normals,
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path, is_nerf_synthetic=True)


def load_scene_info(source_path: str, **kwargs) -> SceneInfo:
    """Dispatch on directory contents (reference scene/__init__.py:43-49)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path, **kwargs)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        print("Found transforms_train.json file, assuming Blender data set!")
        kwargs.pop("images", None)
        kwargs.pop("train_test_exp", None)
        kwargs.pop("llffhold", None)
        return read_blender_scene(source_path, **kwargs)
    raise ValueError(f"Could not recognize scene type for {source_path}")
