"""Gaussians made to hit every branch of the per-Gaussian preprocess
(kernel H, gslm_tpu_torch/csrc/preprocess.cu, against the plain graph of
gslm_tpu_torch/ops/projection.py): rows about the near plane and behind
the camera, at the image's edges and off screen, with opacity at and under
1/255, with covariances that overflow (det not > 0) or vanish, zero and
huge quaternions, and non-finite parameters. Shared by the card tests
(tests/test_torch_cuda.py). Imports no JAX."""

import math

import numpy as np


def edge_groups(world_view: np.ndarray, width: int, height: int,
                tanfovx: float, tanfovy: float, sh_degree: int = 3,
                seed: int = 0) -> dict:
    """The six per-Gaussian groups (numpy float32, no exposure) of about
    1,100 rows placed for the camera ``world_view`` (4, 4) with the given
    size and half-angle tangents."""
    rng = np.random.default_rng(seed)
    c2w = np.linalg.inv(world_view.astype(np.float64))

    def world(v):                       # view-space points -> world
        v = np.asarray(v, np.float64)
        h = np.c_[v, np.ones(len(v))] @ c2w.T
        return h[:, :3]

    def at_pixel(px, py, z):            # view point seen at pixel (px, py)
        x = (2.0 * (np.asarray(px) + 0.5) / width - 1.0) * tanfovx * z
        y = (2.0 * (np.asarray(py) + 0.5) / height - 1.0) * tanfovy * z
        return np.c_[x, y, z]

    rows = []
    # a cloud around the camera: in front, behind, off to the sides
    rows.append(world(rng.uniform(-6.0, 6.0, (256, 3))))
    # about the near plane at z = 0.2 (and just either side), on screen
    z = np.repeat([0.19, 0.2, np.nextafter(np.float32(0.2), 1), 0.21,
                   0.5, -0.3], 8)
    rows.append(world(at_pixel(rng.uniform(0, width, z.size),
                               rng.uniform(0, height, z.size), z)))
    # on and just past the image's edges and tile boundaries
    px = np.r_[[-40.0, -8.0, -0.5, 0.0, 15.5, 16.0, width - 1.0, width,
                width + 8.0, width + 40.0], rng.uniform(0, width, 14)]
    py = np.r_[[-40.0, -8.0, -0.5, 0.0, 15.5, 16.0, height - 1.0, height,
                height + 8.0, height + 40.0], rng.uniform(0, height, 14)]
    gx, gy = np.meshgrid(px, py)
    zz = rng.uniform(1.0, 8.0, gx.size)
    rows.append(world(at_pixel(gx.ravel(), gy.ravel(), zz)))
    # far away (tiny footprints) and at the field of view's clamp
    rows.append(world(at_pixel(rng.uniform(-2 * width, 3 * width, 32),
                               rng.uniform(-2 * height, 3 * height, 32),
                               rng.uniform(50.0, 1e4, 32))))
    xyz = np.concatenate(rows).astype(np.float32)
    n = len(xyz)
    k = (sh_degree + 1) ** 2 - 1
    g = dict(
        xyz=xyz,
        features_dc=rng.normal(0.0, 0.5, (n, 1, 3)),
        features_rest=rng.normal(0.0, 0.3, (n, k, 3)),
        scaling=rng.uniform(-5.0, 0.5, (n, 3)),
        rotation=rng.normal(0.0, 1.0, (n, 4)),
        opacity=rng.uniform(-7.0, 4.0, (n, 1)))
    g = {key: np.asarray(v, np.float32) for key, v in g.items()}

    def some(m):                        # m distinct rows to edit
        return rng.choice(n, m, replace=False)

    # opacity at and about 1/255 (sigmoid(-ln 254) = 1/255), and extremes
    o = np.float32(-np.log(254.0))
    g["opacity"][some(40), 0] = np.r_[
        np.repeat([o, np.nextafter(o, -np.inf), np.nextafter(o, np.inf)], 10),
        [-30.0, -17.0, 17.0, 30.0, 88.0, -88.0, np.inf, -np.inf, np.nan,
         0.0]]
    # covariances that overflow (det NaN, not > 0) or vanish (det 0.09)
    g["scaling"][some(24)] = np.r_[
        np.repeat([[50.0, 0.0, 0.0], [30.0, 30.0, 30.0], [90.0, -5.0, -5.0],
                   [-50.0, -50.0, -50.0], [-12.0, -12.0, 2.0],
                   [20.0, -40.0, -40.0]], 4, axis=0)]
    # zero, huge, tiny and non-finite quaternions
    g["rotation"][some(20)] = np.r_[
        np.repeat([[0.0, 0.0, 0.0, 0.0], [1e30, 0.0, 0.0, 1e30],
                   [1e-30, 1e-30, 0.0, 0.0], [np.nan, 1.0, 0.0, 0.0],
                   [np.inf, 0.0, 1.0, 0.0]], 4, axis=0)]
    # non-finite means, scales, opacities and SH coefficients
    g["xyz"][some(6)] = [[np.nan, 0, 0], [0, np.inf, 0], [0, 0, -np.inf],
                         [1e38, 1e38, 1e38], [-1e38, 0, 1e38],
                         [np.nan, np.nan, np.nan]]
    g["scaling"][some(4)] = [[np.nan, 0, 0], [np.inf, 0, 0],
                             [-np.inf, -np.inf, -np.inf], [0, np.nan, 0]]
    g["features_dc"][some(4)] = [[[np.nan, 0, 0]], [[np.inf, 0, 0]],
                                 [[0, -np.inf, 0]], [[1e30, -1e30, 0]]]
    if k:
        g["features_rest"][some(4), k - 1] = [[np.nan, 0, 0], [np.inf, 0, 0],
                                              [0, -np.inf, 0], [1e30, 0, 0]]
    return g


def look_at(radius: float, azimuth: float, elevation: float, fov_deg: float,
            height: int, width: int):
    """A camera at ``radius`` from the origin and looking at it, at the
    given azimuth and elevation (radians): (world_view, full_proj, campos,
    tanfovx, tanfovy) as numpy float32, with the port's near and far
    planes."""
    fovx = math.radians(fov_deg)
    c = radius * np.array([math.sin(azimuth) * math.cos(elevation),
                           math.sin(elevation),
                           -math.cos(azimuth) * math.cos(elevation)])
    z = -c / np.linalg.norm(c)
    x = np.cross(np.array([0.0, -1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    r_wc = np.stack([x, np.cross(z, x), z], axis=0)
    wv = np.eye(4)
    wv[:3, :3] = r_wc
    wv[:3, 3] = -r_wc @ c
    tx = math.tan(fovx / 2)
    ty = tx * height / width
    near, far = 0.01, 100.0
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tx, 1.0 / ty
    proj[2, 2], proj[2, 3] = far / (far - near), -far * near / (far - near)
    proj[3, 2] = 1.0
    wv32 = wv.astype(np.float32)
    return (wv32, (proj.astype(np.float32) @ wv32).astype(np.float32),
            np.linalg.inv(wv)[:3, 3].astype(np.float32), np.float32(tx),
            np.float32(ty))
