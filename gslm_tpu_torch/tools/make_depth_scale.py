"""Align monocular inverse-depth maps to COLMAP's sparse depth
(gslm_tpu/tools/make_depth_scale.py, the reference's
utils/make_depth_scale.py).

For every image: the inverse depths of its COLMAP points, the monocular
16-bit inverse-depth PNG sampled at the same pixels, and a per-image
(scale, offset) that matches their medians and mean absolute deviations.
Writes ``sparse/0/depth_params.json``, which the scene loaders read for
depth-regularised training. A thread pool runs the images.

The map is read by the port's PNG codec in OpenCV's channel order
(``data/png.read_png_cv2``) and sampled by the port's copy of
``cv2.remap`` (``data/resample.remap_linear_replicate``). The samples are
flattened, as the JAX package does, where the reference indexes
``[..., 0]`` (which keeps one sample under OpenCV 5.x).

Usage: python -m gslm_tpu_torch.tools.make_depth_scale --base_dir <scene>
       --depths_dir <scene>/depths [--model_type bin]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gslm_tpu_torch.data import colmap
from gslm_tpu_torch.data.png import read_png_cv2
from gslm_tpu_torch.data.resample import remap_linear_replicate
from gslm_tpu_torch.utils.graphics import qvec2rotmat


def get_scales(image_meta, cameras, points3d_ordered, depths_dir: str):
    """``{"image_name", "scale", "offset"}`` of one COLMAP image, or None
    where its depth PNG is missing; scale and offset are 0 where fewer
    than 11 points fall inside the map or their inverse depths span
    1e-3 or less."""
    cam = cameras[image_meta.camera_id]
    pts_idx = image_meta.point3d_ids
    mask = (pts_idx >= 0) & (pts_idx < len(points3d_ordered))
    pts_idx = pts_idx[mask]
    valid_xys = image_meta.xys[mask]
    pts = points3d_ordered[pts_idx] if len(pts_idx) else np.zeros((1, 3))

    R = qvec2rotmat(image_meta.qvec)
    cam_pts = pts @ R.T + image_meta.tvec
    invcolmapdepth = 1.0 / np.maximum(cam_pts[..., 2], 1e-12)

    stem = image_meta.name[: -(len(image_meta.name.split(".")[-1]) + 1)]
    path = os.path.join(depths_dir, stem + ".png")
    if not os.path.exists(path):
        return None
    invmono = read_png_cv2(path)
    if invmono.ndim != 2:
        invmono = invmono[..., 0]
    invmono = invmono.astype(np.float32) / (2 ** 16)
    s = invmono.shape[0] / cam.height

    maps = (valid_xys * s).astype(np.float32)
    valid = ((maps[..., 0] >= 0) & (maps[..., 1] >= 0)
             & (maps[..., 0] < cam.width * s)
             & (maps[..., 1] < cam.height * s) & (invcolmapdepth > 0))

    if valid.sum() > 10 and (invcolmapdepth.max() - invcolmapdepth.min()) > 1e-3:
        maps = maps[valid]
        invcolmapdepth = invcolmapdepth[valid]
        invmonodepth = remap_linear_replicate(invmono, maps[..., 0],
                                              maps[..., 1]).reshape(-1)
        # median / mean-absolute-deviation alignment
        t_colmap = np.median(invcolmapdepth)
        s_colmap = np.mean(np.abs(invcolmapdepth - t_colmap))
        t_mono = np.median(invmonodepth)
        s_mono = np.mean(np.abs(invmonodepth - t_mono))
        scale = s_colmap / s_mono if s_mono > 0 else 0.0
        offset = t_colmap - t_mono * scale
    else:
        scale, offset = 0.0, 0.0
    return {"image_name": stem, "scale": float(scale),
            "offset": float(offset)}


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--depths_dir", required=True)
    parser.add_argument("--model_type", default="bin", choices=["bin", "txt"])
    args = parser.parse_args(argv)

    sparse = os.path.join(args.base_dir, "sparse", "0")
    if args.model_type == "bin":
        cameras = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        images = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        ids, xyz = colmap.read_points3d_binary_with_ids(
            os.path.join(sparse, "points3D.bin"))
    else:
        cameras = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        images = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        ids, xyz = colmap.read_points3d_text_with_ids(
            os.path.join(sparse, "points3D.txt"))

    points3d_ordered = np.zeros((ids.max() + 1 if len(ids) else 1, 3))
    points3d_ordered[ids] = xyz

    with ThreadPoolExecutor() as pool:
        results = list(pool.map(
            lambda im: get_scales(im, cameras, points3d_ordered,
                                  args.depths_dir), images.values()))

    depth_params = {r["image_name"]: {"scale": r["scale"],
                                      "offset": r["offset"]}
                    for r in results if r is not None}
    with open(os.path.join(sparse, "depth_params.json"), "w") as f:
        json.dump(depth_params, f, indent=2)
    print(f"Wrote {len(depth_params)} depth params to "
          f"{os.path.join(sparse, 'depth_params.json')}")


if __name__ == "__main__":
    main()
