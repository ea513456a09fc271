"""gslm_tpu_torch's monocular depth path (data/png.py at 16 bits,
data/resample.py, models/scene.load_camera_pixels on depth maps,
tools/make_depth_scale.py) against OpenCV, which the JAX package calls,
and against gslm_tpu on the same files.

Tolerances: 16-bit PNG decoding equal to ``cv2.imread(path, -1)`` (OpenCV's
BGR(A) order, grey + alpha as BGRA) with ``np.array_equal``, and the port's
16-bit files decoded by OpenCV to the written array; ``resize_linear``
within 1e-6 absolute of ``cv2.resize`` (INTER_LINEAR, float32; 1.8e-7
measured on random sizes); ``remap_linear_replicate`` within 1e-6 of
``cv2.remap`` (INTER_LINEAR, BORDER_REPLICATE), points on and past the
border included (bit for bit here, OpenCV 5.0); ``invdepthmap``, ``depth_mask`` and
``depth_reliable`` within 1e-6 of JAX's; ``get_scales`` within 1e-6
relative of JAX's; ``depth_params.json`` byte for byte."""

import json
import math
import os
import sys

import cv2
import numpy as np
import pytest

from gslm_tpu.data.readers import load_scene_info as j_load_scene_info
from gslm_tpu.models.scene import load_camera_pixels as j_load_camera_pixels
from gslm_tpu.tools import make_depth_scale as j_mds
from gslm_tpu_torch.data import colmap
from gslm_tpu_torch.data.png import read_png, read_png_cv2, write_png
from gslm_tpu_torch.data.readers import load_scene_info
from gslm_tpu_torch.data.resample import remap_linear_replicate, resize_linear
from gslm_tpu_torch.models.scene import load_camera_pixels
from gslm_tpu_torch.tools import make_depth_scale as mds
from gslm_tpu_torch.utils.graphics import fov2focal, qvec2rotmat, rotmat2qvec
from gslm_tpu_torch.utils.synthetic import make_camera
from torch_threads import one_thread  # noqa: F401 (autouse)

CHANNELS = {"grey": 1, "grey+alpha": 2, "RGB": 3, "RGBA": 4}


def _u16(rng, shape):
    return rng.integers(0, 65536, shape, dtype=np.uint16)


@pytest.mark.parametrize("kind", list(CHANNELS))
def test_png16_read_equals_opencv(tmp_path, kind):
    """Files OpenCV writes (its own filters) where it can write the type,
    the port's otherwise: the port's reader in OpenCV's layout equals
    ``cv2.imread(-1)``; the port's writer's file decodes in OpenCV to the
    written array."""
    rng = np.random.default_rng(CHANNELS[kind])
    c = CHANNELS[kind]
    img = _u16(rng, (37, 53, c))
    img[:5] = img[5:10]          # runs that make OpenCV pick other filters
    mine = str(tmp_path / "mine.png")
    write_png(mine, img)
    np.testing.assert_array_equal(read_png(mine), img)
    want = cv2.imread(mine, cv2.IMREAD_UNCHANGED)
    assert want.dtype == np.uint16
    np.testing.assert_array_equal(read_png_cv2(mine), want)
    # OpenCV's layout of the written array
    layout = (img[..., 0] if c == 1 else
              img[..., {2: [0, 0, 0, 1], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[c]])
    np.testing.assert_array_equal(want, layout)
    if c != 2:                   # OpenCV writes no grey + alpha
        theirs = str(tmp_path / "theirs.png")
        assert cv2.imwrite(theirs, want)
        np.testing.assert_array_equal(read_png_cv2(theirs),
                                      cv2.imread(theirs, -1))
        np.testing.assert_array_equal(read_png(theirs), img)


@pytest.mark.parametrize("src,dst", [
    ((540, 960), (1080, 1920)), ((64, 64), (32, 32)), ((60, 50), (30, 25)),
    ((31, 47), (20, 64)), ((60, 50), (91, 37)), ((7, 9), (40, 3)),
    ((20, 28), (20, 28))])
def test_resize_linear_matches_opencv(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.uniform(0, 1, src).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]))
    got = resize_linear(img, (dst[1], dst[0]))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    img3 = rng.uniform(0, 1, src + (3,)).astype(np.float32)
    np.testing.assert_allclose(resize_linear(img3, (dst[1], dst[0])),
                               cv2.resize(img3, (dst[1], dst[0])), rtol=0,
                               atol=1e-6)


def test_remap_matches_opencv():
    """2,000 random points of a 60x50 map, including points past the
    border, on it and on integer positions."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (60, 50)).astype(np.float32)
    mx = rng.uniform(-5, 55, 2000).astype(np.float32)
    my = rng.uniform(-5, 65, 2000).astype(np.float32)
    mx[:10], mx[10:20], my[20:30] = 0, 49, 59
    mx[30:40], my[30:40] = np.arange(10), np.arange(10) * 5
    mx[40:50], my[40:50] = -1.5, 70.25
    want = cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE).reshape(-1)
    got = remap_linear_replicate(img, mx, my)
    assert got.shape == mx.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _colmap_depth_scene(root, n=6, h=40, w=56, dh=20, dw=28):
    """A COLMAP scene (random images) with a 16-bit inverse-depth PNG per
    view at dh x dw, the views cycling through the four colour types, and
    a depth_params.json whose view 2 scale is 0.1x the others (unreliable)
    and view 4 scale is 0 (unreliable too, and no affine)."""
    rng = np.random.default_rng(11)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "depths"))
    cams, ims, params = {}, {}, {}
    for i in range(n):
        m = make_camera(height=h, width=w, angle=2 * math.pi * i / n,
                        radius=5.0, exposure_idx=i)
        name = f"view_{i:03d}"
        write_png(os.path.join(root, "images", name + ".png"),
                  rng.integers(0, 256, (h, w, 3), np.uint8))
        c = list(CHANNELS.values())[i % 4]
        write_png(os.path.join(root, "depths", name + ".png"),
                  _u16(rng, (dh, dw, c)))
        cams[i + 1] = colmap.ColmapCamera(i + 1, "PINHOLE", w, h, np.array(
            [fov2focal(m.fovx, w), fov2focal(m.fovy, h), w / 2, h / 2]))
        ims[i + 1] = colmap.ColmapImage(i + 1, rotmat2qvec(m.R.T),
                                        m.T.astype(np.float64), i + 1,
                                        name + ".png", np.zeros((0, 2)),
                                        np.zeros(0, np.int64))
        params[name] = {"scale": {2: 0.1, 4: 0.0}.get(i, 1.0 + 0.1 * i),
                        "offset": 0.01 * i - 0.02}
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(ims, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(
        rng.normal(0, 1, (50, 3)), rng.integers(0, 256, (50, 3)).astype(
            np.uint8), np.zeros(50), os.path.join(sparse, "points3D.bin"))
    with open(os.path.join(sparse, "depth_params.json"), "w") as f:
        json.dump(params, f)
    return root


def _blender_depth_scene(root, n=3, size=24):
    rng = np.random.default_rng(12)
    os.makedirs(os.path.join(root, "depths"))
    frames = []
    for i in range(n):
        a = 2 * math.pi * i / n
        c2w = np.eye(4)
        c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                       [-math.sin(a), 0, math.cos(a)]]
        c2w[:3, 3] = [3 * math.sin(a), 0.0, 3 * math.cos(a)]
        write_png(os.path.join(root, f"r_{i}.png"),
                  rng.integers(0, 256, (size, size, 4), np.uint8))
        write_png(os.path.join(root, "depths", f"r_{i}.png"),
                  _u16(rng, (size // 2, size // 2, 1 + 2 * (i % 2))))
        frames.append({"file_path": f"r_{i}",
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


@pytest.mark.parametrize("kind,resolution", [
    ("colmap", 1), ("colmap", 2), ("colmap", 30), ("blender", 1),
    ("blender", 2)])
def test_load_camera_pixels_depth_matches_jax(tmp_path, kind, resolution):
    """The COLMAP scene's depth maps up- and downscaled (and at its own
    size with -r 2), an unreliable view among reliable ones, a zero scale;
    the Blender scene's divisor 512, grey and RGB maps."""
    if kind == "colmap":
        src = _colmap_depth_scene(str(tmp_path / "src"))
        kw = {}
    else:
        src = _blender_depth_scene(str(tmp_path / "src"))
        kw = dict(white_background=True)
    want_info = j_load_scene_info(src, depths="depths", **kw)
    os.remove(want_info.ply_path)
    got_info = load_scene_info(src, depths="depths", **kw)
    assert got_info.is_nerf_synthetic == (kind == "blender")
    reliable = []
    for jm, pm in zip(want_info.train_cameras, got_info.train_cameras):
        assert pm.depth_path == jm.depth_path
        assert pm.depth_params == jm.depth_params
        want = j_load_camera_pixels(jm, resolution, 1.0, False, False,
                                    want_info.is_nerf_synthetic)
        got = load_camera_pixels(pm, resolution, 1.0, False, False,
                                 got_info.is_nerf_synthetic)
        assert got.depth_reliable == want.depth_reliable
        reliable.append(got.depth_reliable)
        for f in ("invdepthmap", "depth_mask"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.shape == b.shape == (1, want.height, want.width), f
            assert a.dtype == np.float32, f
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(got.image, want.image)
    if kind == "colmap":
        assert reliable == [i not in (2, 4) for i in range(6)]
    else:
        assert all(reliable)


def _observed_scene(root, n_views=3, n_points=400, channels=(1, 3, 4)):
    """A COLMAP scene whose images observe their points (xys, ids) and
    whose 16-bit mono maps are an affine of each point's inverse depth
    painted at its pixel (half resolution), for ``main``."""
    rng = np.random.default_rng(21)
    h, w = 48, 64
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "depths"))
    pts = rng.uniform(-1, 1, (n_points, 3))
    cams, ims = {}, {}
    for i in range(n_views):
        m = make_camera(height=h, width=w, angle=0.4 * i, radius=4.0,
                        exposure_idx=i)
        cams[i + 1] = colmap.ColmapCamera(i + 1, "PINHOLE", w, h, np.array(
            [fov2focal(m.fovx, w), fov2focal(m.fovy, h), w / 2, h / 2]))
        qvec, tvec = rotmat2qvec(m.R.T), m.T.astype(np.float64)
        cam_pts = pts @ qvec2rotmat(qvec).T + tvec
        fx = fov2focal(m.fovx, w)
        xy = cam_pts[:, :2] / cam_pts[:, 2:] * fx + [w / 2, h / 2]
        ids = np.arange(n_points, dtype=np.int64)
        ids[::7] = -1                        # unobserved entries
        ims[i + 1] = colmap.ColmapImage(i + 1, qvec, tvec, i + 1,
                                        f"im{i}.jpg", xy, ids)
        mono = np.full((h // 2, w // 2), 0.05, np.float32)
        yx = np.clip(np.round(xy[:, ::-1] / 2).astype(int), 0,
                     [h // 2 - 1, w // 2 - 1])
        mono[yx[:, 0], yx[:, 1]] = (1.0 / cam_pts[:, 2] - 0.02) / (1.3 + i)
        u16 = (np.clip(mono, 0, 1) * 65535).astype(np.uint16)
        c = channels[i % len(channels)]
        # the painted channel is the one the tools take: blue of BGR(A)
        layout = u16[..., None].repeat(c, -1)
        if c >= 3:
            layout[..., 0] = 0
        write_png(os.path.join(root, "depths", f"im{i}.png"), layout)
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(ims, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(pts, rng.integers(0, 256, (n_points, 3))
                                 .astype(np.uint8), np.zeros(n_points),
                                 os.path.join(sparse, "points3D.bin"))
    return root


@pytest.mark.parametrize("channels", [1, 3])
def test_get_scales_matches_jax(tmp_path, channels):
    """tests/test_data_io.py's affine scene (mono = affine of the COLMAP
    inverse depth painted at each point's pixel, written by OpenCV), grey
    and BGR: the port's scale and offset equal JAX's within 1e-6
    relative, and recover the affine within 5 %."""
    from gslm_tpu.data.colmap import ColmapImage

    class Cam:
        width, height = 64, 64

    rng = np.random.default_rng(0)
    n = 200
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float64)
    pts[:, 2] = rng.uniform(2.0, 6.0, n)
    qvec, tvec = np.array([1.0, 0, 0, 0]), np.zeros(3)
    inv_colmap = 1.0 / (pts @ qvec2rotmat(qvec).T + tvec)[:, 2]
    true_scale, true_offset = 1.5, 0.02
    xys = rng.uniform(2, 62, (n, 2))
    img = np.zeros((64, 64), np.float32)
    for (x, y), v in zip(xys, (inv_colmap - true_offset) / true_scale):
        img[int(round(y)), int(round(x))] = v
    xys = np.round(xys)
    png = (np.clip(img, 0, 1) * (2 ** 16 - 1)).astype(np.uint16)
    if channels == 3:            # blue carries the map, green and red noise
        png = np.stack([png, png[::-1], png[:, ::-1]], -1)
    cv2.imwrite(str(tmp_path / "im0.png"), png)
    meta = ColmapImage(1, qvec, tvec, 1, "im0.jpg", xys,
                       np.arange(n, dtype=np.int64))
    want = j_mds.get_scales(meta, {1: Cam()}, pts, str(tmp_path))
    got = mds.get_scales(meta, {1: Cam()}, pts, str(tmp_path))
    assert got["image_name"] == want["image_name"] == "im0"
    for k in ("scale", "offset"):
        assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]), (k, got, want)
    assert abs(got["scale"] - true_scale) / true_scale < 0.05
    assert mds.get_scales(meta, {1: Cam()}, pts, str(tmp_path / "none")) \
        is None


def test_depth_params_json_byte_equal(tmp_path, monkeypatch, capsys):
    """Both packages' ``main`` on one scene (grey, BGR and BGRA maps, some
    entries unobserved) write the same depth_params.json."""
    src = _observed_scene(str(tmp_path / "src"))
    out = os.path.join(src, "sparse", "0", "depth_params.json")
    argv = ["--base_dir", src, "--depths_dir", os.path.join(src, "depths")]
    monkeypatch.setattr(sys, "argv", ["make_depth_scale"] + argv)
    j_mds.main()
    with open(out, "rb") as f:
        want = f.read()
    os.remove(out)
    mds.main(argv)
    with open(out, "rb") as f:
        got = f.read()
    assert got == want
    params = json.loads(got)
    assert sorted(params) == ["im0", "im1", "im2"]
    # the maps' affine scales rise from view to view (the painted points
    # blend with the background under the bilinear samples)
    scales = [params[f"im{i}"]["scale"] for i in range(3)]
    assert 0 < scales[0] < scales[1] < scales[2], scales
    assert "Wrote 3 depth params" in capsys.readouterr().out
