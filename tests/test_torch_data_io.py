"""gslm_tpu_torch's scene I/O and initialisation (data/colmap.py,
data/ply.py, data/png.py, data/readers.py, models/scene.py, ops/knn.py,
models/gaussians.create_from_pcd) against gslm_tpu on the same files.

Tolerances: COLMAP and PLY writers byte-identical, their readers exact;
PNG decoding, the PNG writer read back by Pillow and ``resize_uint8``
against Pillow's ``Image.resize``, bit for bit; scene readers and
``Scene`` exact in cameras, pixels, extent and points; the 3-NN within
1e-6 relative of a float64 brute force (its Σ(a−b)² rounds three
differences, three squares and two adds) and within 5e-4 relative of
JAX's, whose ‖a‖²+‖b‖²−2a·b form is itself up to 1.2e-4 relative off the
float64 values here (cancellation: the points sit around (5, 5, 5));
model groups exact but the log-scales made from a point cloud, within
1e-5 absolute: they carry the 3-NN difference, and XLA's and PyTorch's
float32 log and sqrt differ in the last bit even from the same
distances."""

import json
import math
import os
import random
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from gslm_tpu.data import colmap as j_colmap
from gslm_tpu.data import ply as j_ply
from gslm_tpu.data.readers import load_scene_info as j_load_scene_info
from gslm_tpu.models.gaussians import create_from_pcd as j_create_from_pcd
from gslm_tpu.models.scene import Scene as JScene
from gslm_tpu.models.scene import load_gaussians as j_load_gaussians
from gslm_tpu.ops.knn import mean_sq_dist_3nn as j_knn
from gslm_tpu_torch.data import colmap, ply
from gslm_tpu_torch.data.png import load_image, read_png, resize_uint8, write_png
from gslm_tpu_torch.data.readers import load_scene_info
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, create_from_pcd
from gslm_tpu_torch.models.scene import Scene, load_gaussians
from gslm_tpu_torch.ops.knn import mean_sq_dist_3nn
from gslm_tpu_torch.utils.graphics import fov2focal, rotmat2qvec
from gslm_tpu_torch.utils.synthetic import make_camera

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}   # colour types 0, 4, 2, 6


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _colmap_model(rng, n_points=40):
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 640, 480,
                                   np.array([500.0, 510.0, 320.0, 240.0])),
            2: colmap.ColmapCamera(2, "SIMPLE_PINHOLE", 320, 200,
                                   np.array([300.0, 160.0, 100.0]))}
    images = {}
    for i in (1, 2, 3):
        q = rng.normal(size=4)
        images[i] = colmap.ColmapImage(
            i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2,
            f"img_{i:03d}.png", rng.normal(size=(i, 2)),
            rng.integers(-1, 50, i).astype(np.int64))
    pts = (rng.normal(size=(n_points, 3)), rng.integers(0, 256, (
        n_points, 3)).astype(np.uint8), rng.random(n_points))
    return cams, images, pts


def _write_text_model(d, cams, images, pts):
    """COLMAP's text format (neither package writes it)."""
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            f.write(" ".join(map(repr, [im.id, *map(float, im.qvec),
                                        *map(float, im.tvec), im.camera_id]))
                    + f" {im.name}\n")
            f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in
                             zip(im.xys.tolist(), im.point3d_ids)) + "\n")
    xyz, rgb, err = pts
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for i in range(len(xyz)):
            f.write(" ".join(map(repr, [i + 1, *map(float, xyz[i]),
                                        *map(int, rgb[i]), float(err[i])]))
                    + " 1 2\n")


def _same_colmap(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert ca.keys() == cb.keys() and ia.keys() == ib.keys()
    for k in ca:
        assert (ca[k].model, ca[k].width, ca[k].height) == (
            cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].name, ia[k].camera_id) == (ib[k].name, ib[k].camera_id)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f),
                                          getattr(ib[k], f), err_msg=f)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_models_interchange(tmp_path, fmt):
    """Files written by one package read the same in the other; the binary
    writers are byte-identical."""
    cams, images, pts = _colmap_model(np.random.default_rng(0))
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    pd.mkdir()
    if fmt == "binary":
        for mod, d in ((j_colmap, jd), (colmap, pd)):
            mod.write_cameras_binary(cams, str(d / "cameras.bin"))
            mod.write_images_binary(images, str(d / "images.bin"))
            mod.write_points3d_binary(*pts, str(d / "points3D.bin"))
        for name in ("cameras.bin", "images.bin", "points3D.bin"):
            assert _bytes(jd / name) == _bytes(pd / name), name
    else:
        _write_text_model(str(jd), cams, images, pts)
        _write_text_model(str(pd), cams, images, pts)
    ext = "bin" if fmt == "binary" else "txt"
    for d in (jd, pd):
        got = [getattr(mod, f"read_{what}_{fmt}")(str(d / f"{name}.{ext}"))
               for mod in (colmap, j_colmap)
               for what, name in (("cameras", "cameras"),
                                  ("images", "images"),
                                  ("points3d", "points3D"))]
        _same_colmap(got[:3], got[3:])
        ids = [mod.__dict__[f"read_points3d_{fmt}_with_ids"](
            str(d / f"points3D.{ext}")) for mod in (colmap, j_colmap)]
        for x, y in zip(*ids):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[2][1], pts[1])
    np.testing.assert_array_equal(got[2][0], pts[0])


@pytest.mark.parametrize("kind", ["point_cloud", "gaussians"])
def test_ply_interchange(tmp_path, kind):
    """Byte-identical files from the same arrays; each package reads the
    other's file exactly."""
    rng = np.random.default_rng(1)
    if kind == "point_cloud":
        xyz = rng.normal(size=(37, 3))
        rgb = rng.integers(0, 256, (37, 3))
        for mod, name in ((j_ply, "j.ply"), (ply, "p.ply")):
            mod.store_point_cloud(str(tmp_path / name), xyz, rgb)
        reads = [mod.fetch_point_cloud(str(tmp_path / name))
                 for mod in (ply, j_ply) for name in ("j.ply", "p.ply")]
        for r in reads[1:]:
            for x, y in zip(reads[0], r):
                np.testing.assert_array_equal(x, y)
    else:
        p = 23
        arrs = dict(xyz=rng.normal(size=(p, 3)),
                    features_dc=rng.normal(size=(p, 1, 3)),
                    features_rest=rng.normal(size=(p, 15, 3)),
                    opacity=rng.normal(size=(p, 1)),
                    scaling=rng.normal(size=(p, 3)),
                    rotation=rng.normal(size=(p, 4)))
        arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
        for mod, name in ((j_ply, "j.ply"), (ply, "p.ply")):
            mod.save_gaussians_ply(str(tmp_path / name), **arrs)
        for mod in (ply, j_ply):
            for name in ("j.ply", "p.ply"):
                back = mod.load_gaussians_ply(str(tmp_path / name))
                for k in arrs:
                    np.testing.assert_array_equal(back[k], arrs[k], err_msg=k)
    assert _bytes(tmp_path / "j.ply") == _bytes(tmp_path / "p.ply")
    np.testing.assert_array_equal(ply.read_ply(str(tmp_path / "j.ply")),
                                  j_ply.read_ply(str(tmp_path / "p.ply")))


def _png_filters(path) -> set:
    """The filter type of every row of an 8-bit non-interlaced PNG."""
    data, pos, idat, head = _bytes(path), 8, [], None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, _, ctype = head[:4]
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, w * c + 1)[:, 0].tolist())


def _pil(img, mode):
    return Image.fromarray(img[..., 0] if img.shape[2] == 1 else img, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reader_matches_pillow_on_every_filter(tmp_path, mode):
    """Pillow's adaptive filtering picks None, Sub, Up and Paeth, and with
    ``optimize=True`` Average as well, on a noisy image; a smooth one is
    written with the defaults. Every filter type occurs (asserted from the
    rows' filter bytes), and the decoded pixels equal Pillow's."""
    rng = np.random.default_rng(2)
    c = MODES[mode]
    y, x = np.mgrid[0:48, 0:64]
    smooth = (np.sin(x / 5.0 + y / 7.0) * 60 + 128)[..., None] + rng.integers(
        0, 4, (48, 64, c))
    images = {"noise.png": (rng.integers(0, 256, (48, 64, c), np.uint8),
                            dict(optimize=True)),
              "smooth.png": (smooth.astype(np.uint8), {})}
    seen = set()
    for name, (img, kw) in images.items():
        path = str(tmp_path / name)
        _pil(img, mode).save(path, **kw)
        seen |= _png_filters(path)
        got = read_png(path)
        assert got.shape == img.shape and got.dtype == np.uint8
        want = np.asarray(Image.open(path))
        np.testing.assert_array_equal(got.reshape(want.shape), want)
        np.testing.assert_array_equal(got, img)
    assert seen == {0, 1, 2, 3, 4}, seen


def _write_filtered_png(path, img, types):
    """Write uint8 (H, W, C) as an 8-bit PNG whose row y is filtered with
    filter type ``types[y]``."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), x[:, :-c]])
    up_left = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    types = np.asarray(types)
    filt = (x - preds[types, np.arange(h)]) & 0xFF
    raw = np.hstack([types[:, None], filt]).astype(np.uint8)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("filters", [(0, 1, 2), (0, 1, 2, 3, 4), (3,), (4,)])
def test_png_reader_takes_every_filter_mix(tmp_path, mode, filters):
    """Rows filtered only with None, Sub and Up (undone row by row), and
    mixes with Average or Paeth (undone one anti-diagonal at a time):
    decoded pixels equal the image written and Pillow's decode."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (37, 53, MODES[mode]), np.uint8)
    types = rng.choice(filters, 37)
    types[:len(filters)] = filters
    path = str(tmp_path / "f.png")
    _write_filtered_png(path, img, types)
    assert _png_filters(path) == set(filters)
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got.reshape(img.shape[:2] + (-1,)),
                                  np.asarray(Image.open(path)).reshape(
                                      img.shape[:2] + (-1,)))


@pytest.mark.parametrize("mode", list(MODES))
def test_png_writer_read_back_by_pillow(tmp_path, mode):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (33, 47, MODES[mode]), np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    back = Image.open(path)
    assert back.mode == mode
    np.testing.assert_array_equal(np.asarray(back),
                                  np.asarray(_pil(img, mode)))
    assert _png_filters(path) == {2}
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(load_image(path), np.asarray(back))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("target", ["/2", "/4", "/8", "w1600", "same"])
def test_resize_matches_pillow_bit_for_bit(mode, target):
    """Pillow's default resize (BICUBIC, antialiased downscale, RGBA
    premultiplied): equal bit for bit, and the same size is a copy."""
    rng = np.random.default_rng(4)
    h, w = (900, 1920) if target == "w1600" else (54, 96)
    img = rng.integers(0, 256, (h, w, MODES[mode]), np.uint8)
    if mode == "RGBA":
        img[..., 3] = rng.choice([0, 1, 77, 128, 254, 255], (h, w))
    size = {"w1600": (1600, int(h / (w / 1600))), "same": (w, h)}.get(
        target) or (round(w / int(target[1:])), round(h / int(target[1:])))
    got = resize_uint8(img, size)
    np.testing.assert_array_equal(got, np.asarray(_pil(img, mode).resize(size)))
    if target == "same":
        assert got is not img


@pytest.mark.parametrize("what", ["palette", "16-bit", "interlaced"])
def test_png_reader_names_what_it_cannot_read(tmp_path, what):
    path = str(tmp_path / "x.png")
    rng = np.random.default_rng(5)
    if what == "palette":
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).convert(
            "P").save(path)
    elif what == "16-bit":
        # read as a depth map (tests/test_torch_depth.py); not as an image
        px = rng.integers(0, 65535, (8, 8), np.uint16)
        Image.fromarray(px).save(path)
        np.testing.assert_array_equal(read_png(path)[..., 0], px)
        with pytest.raises(NotImplementedError, match="x.png"):
            load_image(path)
        return
    else:
        write_png(path, rng.integers(0, 256, (8, 8, 3), np.uint8))
        data = bytearray(_bytes(path))
        data[8 + 8 + 12] = 1   # IHDR's interlace byte
        data[8 + 8 + 13:8 + 8 + 17] = struct.pack(
            ">I", zlib.crc32(bytes(data[12:8 + 8 + 13])))
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(NotImplementedError, match="x.png"):
        read_png(path)


def test_jpeg_needs_pillow(tmp_path, monkeypatch):
    path = str(tmp_path / "v.jpg")
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (16, 16, 3), np.uint8)).save(path)
    np.testing.assert_array_equal(load_image(path),
                                  np.asarray(Image.open(path)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"\.jpg image needs Pillow"):
        load_image(path)


def _colmap_scene(root, n=6, h=40, w=56, n_points=300, seed=0):
    """A COLMAP scene written with the port's writers: random images."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sparse", "0"))
    os.makedirs(os.path.join(root, "images"))
    cams, ims = {}, {}
    for i in range(n):
        m = make_camera(height=h, width=w, angle=2 * math.pi * i / n,
                        radius=5.0, exposure_idx=i)
        name = f"view_{i:03d}.png"
        write_png(os.path.join(root, "images", name),
                  rng.integers(0, 256, (h, w, 3), np.uint8))
        cams[i + 1] = colmap.ColmapCamera(i + 1, "PINHOLE", w, h, np.array(
            [fov2focal(m.fovx, w), fov2focal(m.fovy, h), w / 2, h / 2]))
        ims[i + 1] = colmap.ColmapImage(i + 1, rotmat2qvec(m.R.T),
                                        m.T.astype(np.float64), i + 1, name,
                                        np.zeros((0, 2)),
                                        np.zeros(0, np.int64))
    sparse = os.path.join(root, "sparse", "0")
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(ims, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(
        rng.normal(0, 1, (n_points, 3)),
        rng.integers(0, 256, (n_points, 3)).astype(np.uint8),
        np.zeros(n_points), os.path.join(sparse, "points3D.bin"))
    return root


def _blender_scene(root, n=3, size=24, mode="RGBA"):
    rng = np.random.default_rng(7)
    os.makedirs(root)
    frames = []
    for i in range(n):
        a = 2 * math.pi * i / n
        c2w = np.eye(4)
        c2w[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                       [-math.sin(a), 0, math.cos(a)]]
        c2w[:3, 3] = [3 * math.sin(a), 0.0, 3 * math.cos(a)]
        img = rng.integers(0, 256, (size, size, MODES[mode]), np.uint8)
        write_png(os.path.join(root, f"r_{i}.png"), img)
        frames.append({"file_path": f"r_{i}",
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


def _same_cameras(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("uid", "colmap_id", "fovx", "fovy", "width", "height",
                  "image_name", "image_path", "depth_path", "is_test",
                  "exposure_idx"):
            assert getattr(x, f) == getattr(y, f), f
        for f in ("R", "T", "image", "alpha_mask"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), f
            if u is not None:
                np.testing.assert_array_equal(u, v, err_msg=f)


@pytest.mark.parametrize("kind", ["colmap", "colmap-eval", "blender-RGBA",
                                  "blender-L"])
def test_scene_readers_match(tmp_path, kind):
    if kind.startswith("colmap"):
        src = _colmap_scene(str(tmp_path / "src"))
        kw = dict(eval_split=kind.endswith("eval"), llffhold=3)
    else:
        src = _blender_scene(str(tmp_path / "src"), mode=kind.split("-")[1])
        kw = dict(white_background=True)
    want = j_load_scene_info(src, **kw)
    # the first reader wrote the point cloud's PLY; the port reads it
    os.remove(want.ply_path)
    got = load_scene_info(src, **kw)
    assert got.is_nerf_synthetic == want.is_nerf_synthetic
    _same_cameras(got.train_cameras, want.train_cameras)
    _same_cameras(got.test_cameras, want.test_cameras)
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    assert got.ply_path == want.ply_path


def _same_model(p, jp, j_alive, scale_atol=1e-5):
    for g in PARAM_GROUPS:
        a, b = getattr(p, g).detach().numpy(), np.asarray(getattr(jp, g))
        assert a.shape == b.shape, g
        if g == "scaling":
            np.testing.assert_allclose(a, b, rtol=0, atol=scale_atol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=g)
    np.testing.assert_array_equal(p.alive.numpy(), np.asarray(j_alive))


@pytest.mark.parametrize("resolution,shuffle", [(1, False), (2, True),
                                                (-1, True), (30, False)])
def test_scene_matches(tmp_path, resolution, shuffle):
    """JAX shuffles with the global ``random`` seeded 0, the port with
    ``random.Random(0)``: the same camera order; pixels, extent and the
    model from the point cloud as the JAX Scene's."""
    src = _colmap_scene(str(tmp_path / "src"))
    random.seed(0)
    js = JScene(src, str(tmp_path / "jm"), resolution=resolution,
                shuffle=shuffle)
    ps = Scene(src, str(tmp_path / "pm"), resolution=resolution,
               shuffle=shuffle, device="cpu", rng=random.Random(0))
    assert ps.cameras_extent == js.cameras_extent
    assert ps.exposure_mapping == js.exposure_mapping
    _same_cameras(ps.get_train_cameras(), js.get_train_cameras())
    _same_cameras(ps.get_test_cameras(), js.get_test_cameras())
    _same_model(ps.params, js.params, js.aux.alive)
    assert _bytes(tmp_path / "pm" / "cameras.json") == _bytes(
        tmp_path / "jm" / "cameras.json")
    assert _bytes(tmp_path / "pm" / "input.ply") == _bytes(
        tmp_path / "jm" / "input.ply")


def test_scene_save_and_reload(tmp_path):
    """``Scene.save`` writes what the JAX Scene writes for the same model,
    and both packages reload it (``load_iteration=-1``) to the same
    rows."""
    src = _colmap_scene(str(tmp_path / "src"), n_points=200)
    ps = Scene(src, str(tmp_path / "pm"), resolution=1, shuffle=False,
               capacity=512, device="cpu")
    with torch.no_grad():
        ps.params.exposure.add_(0.25)
        ps.params.alive[::3] = False
    ps.save(7)
    js = JScene(src, str(tmp_path / "jm"), resolution=1, shuffle=False,
                capacity=512)
    js.params = js.params.replace(**{g: jnp.asarray(
        getattr(ps.params, g).detach().numpy()) for g in PARAM_GROUPS})
    js.aux = js.aux.replace(alive=jnp.asarray(ps.params.alive.numpy()))
    js.save(7)
    for name in ("point_cloud/iteration_7/point_cloud.ply", "exposure.json"):
        assert _bytes(tmp_path / "pm" / name) == _bytes(
            tmp_path / "jm" / name), name

    back = Scene(src, str(tmp_path / "pm"), resolution=1, shuffle=False,
                 load_iteration=-1, capacity=512, train_test_exp=True,
                 device="cpu")
    jback = JScene(src, str(tmp_path / "pm"), resolution=1, shuffle=False,
                   load_iteration=-1, capacity=512, train_test_exp=True)
    assert back.loaded_iter == 7
    _same_model(back.params, jback.params, jback.aux.alive, scale_atol=0)
    live = ps.params.alive
    n = int(live.sum())
    assert int(back.params.alive.sum()) == n
    for g in PARAM_GROUPS[:-1]:
        torch.testing.assert_close(getattr(back.params, g)[:n],
                                   getattr(ps.params, g)[live], rtol=0,
                                   atol=0)
    torch.testing.assert_close(back.params.exposure, ps.params.exposure,
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,spread", [(300, 1.0), (2000, 10.0)])
def test_mean_sq_dist_3nn(n, spread):
    rng = np.random.default_rng(8)
    pts = (rng.normal(0, spread, (n, 3)) + 5.0).astype(np.float32)
    pts[7] = pts[3]      # a duplicate keeps its zero distance
    got = mean_sq_dist_3nn(torch.tensor(pts)).numpy()
    p64 = pts.astype(np.float64)
    d2 = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    want = np.sort(d2, axis=1)[:, 1:4].mean(axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(j_knn(jnp.asarray(pts))),
                               rtol=5e-4)


@pytest.mark.parametrize("with_dist", [False, True])
def test_create_from_pcd_and_load_gaussians(tmp_path, with_dist):
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 1, (300, 3))
    colors = rng.random((300, 3))
    msd = rng.random(300) * 0.01 if with_dist else None
    p, aux = create_from_pcd(pts, colors, num_images=5, capacity=512,
                             mean_sq_dist=msd, device="cpu")
    jp, jaux = j_create_from_pcd(pts, colors, num_images=5, capacity=512,
                                 mean_sq_dist=msd)
    _same_model(p, jp, jaux.alive)
    for f in ("max_radii2d", "xyz_gradient_accum", "denom"):
        np.testing.assert_array_equal(getattr(aux, f).numpy(),
                                      np.asarray(getattr(jaux, f)))

    path = str(tmp_path / "g.ply")
    live = p.alive.numpy()
    ply.save_gaussians_ply(path, *(getattr(p, g).detach().numpy()[live] for g in (
        "xyz", "features_dc", "features_rest", "opacity", "scaling",
        "rotation")))
    for cap in (None, 1024):
        q, qaux = load_gaussians(path, num_images=5, capacity=cap,
                                 device="cpu")
        jq, jqaux = j_load_gaussians(path, num_images=5, capacity=cap)
        _same_model(q, jq, jqaux.alive, scale_atol=0)
        assert q.capacity == (cap or 512) and qaux.denom.shape == (q.capacity,)
