"""gslm_tpu_torch's counterparts of the JAX package's native library
(gslm_tpu/native.py): the 3-NN mean squared distance (ops/knn.py: the
plain version, and a numpy mirror of kernel F's grid search on the grid
``build_grid`` makes) and the points3D.bin parse (data/colmap.py).

Tolerances: none. The plain version equals JAX's native library bit for
bit (both form (dx·dx + dy·dy) + dz·dz and sum (d1 + d2) + d3 in float32,
each operation rounded on its own), but for fewer than four points, where
the native library divides by the count it found and the port by 3 (a
recorded departure, held here exactly). ``rows=`` equals the full call bit
for bit. Kernel F's mirror equals the plain version bit for bit on clouds
made to break a grid search: points on cell faces, coplanar, collinear and
identical points, duplicates, P from 1 to 5, clusters with far outliers.
``create_from_pcd`` without a given 3-NN (JAX then takes its native path)
equals JAX's model exactly but the log-scales, within 1e-6: XLA's and
PyTorch's float32 log and sqrt may differ in the last bit. The parse
equals JAX's native parser and its per-record loop reader exactly."""

import struct

import numpy as np
import pytest
import torch

import gslm_tpu.data.colmap as j_colmap
from gslm_tpu import native
from gslm_tpu.models.gaussians import create_from_pcd as j_create_from_pcd
from gslm_tpu_torch.data import colmap
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, create_from_pcd
from gslm_tpu_torch.ops.knn import (POINTS_PER_CELL, RING_DEFER, build_grid,
                                    grid_dims, mean_sq_dist_3nn,
                                    mean_sq_dist_3nn_plain)
from gslm_tpu_torch.utils.synthetic import clustered_cloud
from knn_cases import hard_clouds
from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the JAX package's native library is unavailable")
    return native


def _cloud(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        pts = rng.normal(0.0, 1.0, (n, 3)) + 5.0
    elif kind == "uniform":
        pts = rng.uniform(-1.0, 1.0, (n, 3))
    elif kind == "clustered":
        pts = clustered_cloud(rng, n)
    else:   # "duplicate": a normal cloud whose last point is its first
        pts = rng.normal(0.0, 1.0, (n, 3))
        pts[-1] = pts[0]
    return np.asarray(pts, np.float32)


def _plain(pts: np.ndarray, **kw) -> np.ndarray:
    return mean_sq_dist_3nn_plain(torch.tensor(pts), **kw).numpy()


@pytest.mark.parametrize("n", [4, 5, 300, 2000])
@pytest.mark.parametrize("kind", ["normal", "uniform", "clustered",
                                  "duplicate"])
def test_plain_equals_jax_native(lib, kind, n):
    pts = _cloud(kind, n)
    got = _plain(pts)
    np.testing.assert_array_equal(got, lib.mean_sq_dist_3nn(pts))
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(mean_sq_dist_3nn(torch.tensor(pts)).numpy(),
                                  got)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_fewer_than_four_points(lib, n):
    """The recorded departure: the P − 1 distances there are, summed in
    ascending order, over 3 in the port and over P − 1 in the native
    library."""
    pts = _cloud("normal", n, seed=n)
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2)
    d = np.sort((d[..., 0] + d[..., 1]) + d[..., 2], axis=1)[:, 1:]
    s = np.zeros(n, np.float32)
    for c in range(n - 1):
        s = s + d[:, c]
    np.testing.assert_array_equal(_plain(pts), s / np.float32(3))
    want = s / np.float32(n - 1) if n > 1 else s
    np.testing.assert_array_equal(lib.mean_sq_dist_3nn(pts), want)


@pytest.mark.parametrize("chunk", [1, 7, 1024])
def test_rows_equal_the_full_call(chunk):
    pts = _cloud("clustered", 1500, seed=3)
    full = _plain(pts)
    rows = np.random.default_rng(5).choice(len(pts), 97, replace=False)
    np.testing.assert_array_equal(_plain(pts, chunk=chunk, rows=rows),
                                  full[rows])
    np.testing.assert_array_equal(_plain(pts, chunk=chunk), full)


# ---- kernel F's search, mirrored in numpy ----------------------------------

def _round_down(x: float) -> np.float32:
    f = np.float32(x)
    return np.nextafter(f, np.float32(-np.inf)) if float(f) > x else f


def _ring_cells(k, r, dims, items: bool):
    """Ring r's shell about cell k as ranges of cell ids [b, e): in the
    first pass's loop order, or (``items``) as the second pass's items,
    two per (z, y) row of the block, q = 2 * row + slot."""
    dx, dy, dz = dims
    x0, x1 = max(k[0] - r, 0), min(k[0] + r, dx - 1)
    y0, y1 = max(k[1] - r, 0), min(k[1] + r, dy - 1)
    z0, z1 = max(k[2] - r, 0), min(k[2] + r, dz - 1)
    out = []
    if items:
        ny = y1 - y0 + 1
        for q in range(2 * ny * (z1 - z0 + 1)):
            z, y = z0 + (q >> 1) // ny, y0 + (q >> 1) % ny
            row = (z * dy + y) * dx
            if abs(z - k[2]) == r or abs(y - k[1]) == r:
                if q & 1 == 0:
                    out.append((row + x0, row + x1 + 1))
            else:
                x = k[0] + r if q & 1 else k[0] - r
                if 0 <= x < dx:
                    out.append((row + x, row + x + 1))
        return out
    for z in range(z0, z1 + 1):
        for y in range(y0, y1 + 1):
            row = (z * dy + y) * dx
            if abs(z - k[2]) == r or abs(y - k[1]) == r:
                out.append((row + x0, row + x1 + 1))
            else:
                out += [(row + x, row + x + 1) for x in (k[0] - r, k[0] + r)
                        if 0 <= x < dx]
    return out


def _search(g, pts, starts, t, k, cap, items):
    """One point's ring search (kernel F's, either pass): (its three
    smallest distances or None if handed on at ring ``cap``, the
    candidate pairs it evaluated)."""
    p = pts[t]
    best, pairs, r = np.zeros(0, np.float32), 0, 0
    while True:
        idx = np.concatenate([np.arange(starts[b], starts[e]) for b, e in
                              _ring_cells(k, r, g.dims, items)]
                             + [np.zeros(0, np.int64)])
        q = pts[idx[idx != t]]
        d = ((p[0] - q[:, 0]) * (p[0] - q[:, 0])
             + (p[1] - q[:, 1]) * (p[1] - q[:, 1])) \
            + (p[2] - q[:, 2]) * (p[2] - q[:, 2])
        pairs += len(d)
        best = np.sort(np.concatenate([best, d]))[:3]
        gap, inside = np.inf, False
        for a in range(3):
            if k[a] + r + 1 < g.dims[a]:
                inside = True
                gap = min(gap, (g.lo[a] + (k[a] + r + 1) * g.cell[a]
                                - g.margin[a]) - float(p[a]))
            if k[a] - r - 1 >= 0:
                inside = True
                gap = min(gap, float(p[a]) - (g.lo[a] + (k[a] - r)
                                              * g.cell[a] + g.margin[a]))
        if not inside:
            return best, pairs
        if len(best) == 3 and gap > 0:
            gf = _round_down(gap)
            if gf * gf >= best[2]:
                return best, pairs
        if r == cap:
            return None, pairs
        r += 1


def _kernel_f(points: np.ndarray):
    """Kernel F (csrc/knn.cu) step for step on ``build_grid``'s grid of
    CPU ``points``: the first pass per sorted point (rings of cells in its
    loop order, the distances in float32 as the kernel rounds them, the
    stop at fl(g·g) >= d3 with g the least gap to a face inside the grid
    rounded down), handing a point on after ring ``RING_DEFER``; the
    second pass from ring 0 over its items (two per row of the block).
    The lanes' butterfly merge keeps the three smallest of the union, so
    one list stands for the warp's. Returns (out, candidate pairs per
    point over both passes, the points handed on, the grid)."""
    g = build_grid(torch.tensor(points))
    pts = g.points.numpy()[:, :3]
    cells, starts, order = (g.cells.numpy(), g.starts.numpy(),
                            g.order.numpy())
    dx, dy, _ = g.dims
    out = np.zeros(len(pts), np.float32)
    pairs = np.zeros(len(pts), np.int64)
    handed = 0
    for t in range(len(pts)):
        c = int(cells[t])
        k = (c % dx, (c // dx) % dy, c // (dx * dy))
        best, pairs[order[t]] = _search(g, pts, starts, t, k, RING_DEFER,
                                        False)
        if best is None:
            handed += 1
            best, more = _search(g, pts, starts, t, k, -1, True)
            pairs[order[t]] += more
        s = np.float32(0.0)
        for v in best:
            s = np.float32(s + v)
        out[order[t]] = s / np.float32(3)
    return out, pairs, handed, g


@pytest.mark.parametrize("case", list(hard_clouds()))
def test_kernel_f_mirror_equals_plain(case):
    pts = hard_clouds()[case]
    got, pairs, handed, g = _kernel_f(pts)
    np.testing.assert_array_equal(got, _plain(pts))
    assert np.prod(g.dims) <= max(1, len(pts) // POINTS_PER_CELL)
    assert np.all(pairs >= min(len(pts) - 1, 3))
    # the second pass runs where points lie far from the rest
    assert (handed > 0) == (case in ("far_outliers", "clustered", "normal"))


def test_grid_dims():
    assert grid_dims([1.0, 1.0, 1.0], 1000) == (10, 10, 10)
    assert grid_dims([4.0, 2.0, 0.0], 32) == (8, 4, 1)
    assert grid_dims([1.0, 1e-9, 1.0], 100) == (10, 1, 10)
    assert grid_dims([0.0, 0.0, 0.0], 100) == (1, 1, 1)
    for ext in ([3.0, 1.0, 0.5], [1e-3, 7.0, 7.0], [1.0, 1.0, 1e6]):
        for target in (1, 5, 64, 1000, 65_536):
            assert np.prod(grid_dims(ext, target)) <= target


def test_build_grid_box_leaves_the_outliers_out():
    """The box spans the clusters, not the 1 % outliers at 100x their
    spread, which fall into the boundary cells; the points come sorted by
    cell with each cell's start."""
    pts = clustered_cloud(np.random.default_rng(2), 4000)
    g = build_grid(torch.tensor(pts))
    assert np.all(np.ptp(pts, axis=0) > 6.0)
    assert all(c * d < 2.5 for c, d in zip(g.cell, g.dims))
    order, starts = g.order.numpy(), g.starts.numpy()
    assert np.array_equal(np.sort(order), np.arange(len(pts)))
    assert np.array_equal(g.points.numpy()[:, :3], pts[order])
    assert np.all(np.diff(starts) >= 0) and starts[-1] == len(pts)
    cells = g.cells.numpy()
    assert np.all(np.diff(cells) >= 0)
    assert np.array_equal(starts[cells], np.searchsorted(cells, cells))


def test_create_from_pcd_without_a_given_3nn(lib):
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 1, (300, 3))
    colors = rng.random((300, 3))
    p, _ = create_from_pcd(pts, colors, num_images=5, capacity=512,
                           device="cpu")
    jp, _ = j_create_from_pcd(pts, colors, num_images=5, capacity=512)
    for g in PARAM_GROUPS:
        got, want = getattr(p, g).detach().numpy(), np.asarray(getattr(jp, g))
        if g == "scaling":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=g)
    # the distances under them are the native library's, bit for bit
    msd = lib.mean_sq_dist_3nn(pts.astype(np.float32))
    np.testing.assert_array_equal(_plain(pts.astype(np.float32)), msd)


# ---- points3D.bin -----------------------------------------------------------

def _write_points3d(path, n: int, seed: int = 0):
    """points3D.bin with track lengths 0-4 (the writers write 0 only), the
    last one 3."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    xyz, err = rng.normal(size=(n, 3)), rng.random(n)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<qdddBBBd", ids[i], *xyz[i], *rgb[i],
                                err[i]))
            tlen = 3 if i == n - 1 else int(rng.integers(0, 5))
            f.write(struct.pack("<Q", tlen))
            f.write(rng.integers(0, 99, 2 * tlen).astype(np.int32).tobytes())
    return ids, xyz, rgb, err


def test_points3d_parse_matches_jax(lib, tmp_path, monkeypatch):
    path = str(tmp_path / "points3D.bin")
    ids, xyz, rgb, err = _write_points3d(path, 513)
    got = colmap.read_points3d_binary(path)
    for a, b in zip(got, lib.parse_points3d_bin(path)):
        assert a.dtype == b.dtype and a.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, (xyz, rgb, err)):
        np.testing.assert_array_equal(a, b)
    got_ids = colmap.read_points3d_binary_with_ids(path)
    np.testing.assert_array_equal(got_ids[0], ids)
    np.testing.assert_array_equal(got_ids[1], xyz)
    # JAX's per-record loop (its reader without the native library)
    monkeypatch.setattr(native, "parse_points3d_bin", lambda _: None)
    for a, b in zip(got, j_colmap.read_points3d_binary(path)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got_ids, j_colmap.read_points3d_binary_with_ids(path)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cut", ["count", "record", "track"])
def test_points3d_truncated_raises(tmp_path, cut):
    path = str(tmp_path / "points3D.bin")
    _write_points3d(path, 40, seed=2)
    with open(path, "rb") as f:
        buf = f.read()
    # inside the count, the first record, the last record's track
    end = {"count": 5, "record": 8 + 20, "track": len(buf) - 1}[cut]
    with open(path, "wb") as f:
        f.write(buf[:end])
    with pytest.raises(ValueError, match="truncated"):
        colmap.read_points3d_binary(path)
    with pytest.raises(ValueError, match="truncated"):
        colmap.read_points3d_binary_with_ids(path)
