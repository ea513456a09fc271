"""Mean squared distance to the 3 nearest neighbours, which seeds the
log-scales of a model made from a point cloud: kernel F (csrc/knn.cu) and
its plain version. Counterpart of the JAX package's native library
(``gslm_tpu/native.py``, the grid search of ``native/gslm_native.cpp``
that its ``create_from_pcd`` prefers) and of ``gslm_tpu/ops/knn.py``.

Both versions take, per point, the three smallest squared distances to
the other points, each formed as (dx·dx + dy·dy) + dz·dz in float32 with
every operation rounded on its own, and return ((d1 + d2) + d3) / 3 with
d1 ≤ d2 ≤ d3: the arithmetic of the native library, so all three agree bit
for bit. A duplicate point keeps its zero. With fewer than four points the
P − 1 distances there are are summed, still over 3 (the native library
divides by the count it found). JAX's own brute force forms
‖a‖² + ‖b‖² − 2a·b, which cancels badly when the neighbours are close next
to the points' norms; none of this does.

The plain version is chunked brute force on the points' device; each row
is computed on its own, so neither ``chunk`` (the rows per distance block)
nor ``rows`` changes a value. Kernel F searches a uniform grid instead
(``build_grid`` here in PyTorch, the search in the kernel's two passes:
a thread per point, then a warp per point not done after ``RING_DEFER``
rings)."""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from gslm_tpu_torch import _build

BOX_TAIL = 0.01       # points beyond each face of the grid's box, per axis
POINTS_PER_CELL = 2   # mean points per cell of the grid
MARGIN_REL = 1e-6     # a cell index's slack, of the box's extent per axis
RING_DEFER = 2        # kernel F's first pass's last ring (csrc/knn.cu)


def mean_sq_dist_3nn_plain(points: torch.Tensor, chunk: int = 1024,
                           rows=None) -> torch.Tensor:
    """points (P, 3) → (P,) float32: the mean of the squared distances to
    the 3 nearest other points, on the points' device; with ``rows`` (an
    index array) only those rows, bit for bit as the full call gives
    them. A (chunk, P) block of distances is live at a time (512 MiB at
    the default and P = 131,072), with a second one and topk's
    workspace."""
    pts = points.to(torch.float32)
    p = pts.shape[0]
    sel = pts if rows is None else pts[torch.as_tensor(
        np.asarray(rows, np.int64), device=pts.device)]
    n = sel.shape[0]
    chunk = max(1, min(n, int(chunk)))
    k = min(4, p)
    cols = [pts[:, i].contiguous() for i in range(3)]
    out = torch.zeros(n, dtype=torch.float32, device=pts.device)
    three = torch.full((), 3.0, device=pts.device)
    with torch.no_grad():
        for lo in range(0, n, chunk):
            r = sel[lo:lo + chunk]
            d2 = torch.sub(r[:, 0:1], cols[0][None, :])
            d2.mul_(d2)
            t = torch.sub(r[:, 1:2], cols[1][None, :])
            d2.add_(t.mul_(t))
            torch.sub(r[:, 2:3], cols[2][None, :], out=t)
            d2.add_(t.mul_(t))
            # the k smallest, ascending: the first is the point's own zero
            top = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
            if k < 2:
                continue
            s = top[:, 1]
            for c in range(2, k):
                s = s + top[:, c]          # (d1 + d2) + d3
            # over a tensor 3: CUDA divides by a Python number as a
            # multiply by its reciprocal, one rounding off the quotient
            out[lo:lo + chunk] = s / three
    return out


class KnnGrid(NamedTuple):
    """Kernel F's grid over a cloud: the points sorted by cell id (x
    fastest) and the cells' starts, per axis the box's low corner, the
    cell size and the cell count, and the margin a cell index may be off
    by, in coordinates."""
    points: torch.Tensor   # (P, 4) float32, cell order, w = 0
    cells: torch.Tensor    # (P,) int32, each sorted point's cell id
    starts: torch.Tensor   # (ncells + 1,) int32
    order: torch.Tensor    # (P,) int64, each sorted point's input index
    lo: tuple              # float32 values, per axis
    cell: tuple            # float32 values, per axis
    margin: tuple          # per axis
    dims: tuple            # cells per axis


def grid_dims(ext, target: int) -> tuple:
    """Cells per axis for a box of extents ``ext`` (3 floats): cells of
    one size s, at most ``target`` of them; an axis shorter than s is one
    cell thick and leaves s to the others."""
    dims = [1, 1, 1]
    axes = [a for a in range(3) if ext[a] > 0]
    while axes:
        s = math.prod(ext[a] for a in axes) ** (1.0 / len(axes)) \
            / target ** (1.0 / len(axes))
        short = [a for a in axes if ext[a] < s]
        if not short:
            for a in axes:
                dims[a] = max(1, int(ext[a] / s * (1 + 1e-12)))
            break
        axes = [a for a in axes if a not in short]
    while math.prod(dims) > max(1, target):   # the rounding above
        dims[dims.index(max(dims))] -= 1
    return tuple(dims)


def build_grid(points: torch.Tensor) -> KnnGrid:
    """Kernel F's grid over ``points`` (P, 3), on their device: the box
    per axis from the quantiles that leave ``BOX_TAIL`` of the points
    beyond each face (points beyond it fall into the boundary cells,
    which so reach to infinity: far outliers do not stretch the grid),
    about ``POINTS_PER_CELL`` points per cell (``grid_dims``), then a
    stable counting sort of the points by cell id."""
    pts = points.detach().to(torch.float32).contiguous()
    p = pts.shape[0]
    dev = pts.device
    q = int(p * BOX_TAIL)
    srt = torch.sort(pts, dim=0).values
    lo, hi = srt[q].tolist(), srt[p - 1 - q].tolist()
    del srt
    ext = [h - l for l, h in zip(lo, hi)]   # exact in double
    dims = list(grid_dims(ext, max(1, p // POINTS_PER_CELL)))
    cell = []
    for a in range(3):
        c = float(np.float32(ext[a] / dims[a])) if dims[a] > 1 else 0.0
        if c <= 0.0:   # no extent along the axis: one cell
            dims[a], c = 1, 1.0
        cell.append(c)
    margin = tuple(MARGIN_REL * e + 1e-15 * (abs(l) + abs(h))
                   for e, l, h in zip(ext, lo, hi))
    lo_t = torch.tensor(lo, dtype=torch.float32, device=dev)
    cell_t = torch.tensor(cell, dtype=torch.float32, device=dev)
    top = torch.tensor([d - 1 for d in dims], dtype=torch.float32,
                       device=dev)
    # the index as the kernel's margin assumes it: (x - lo) / c, floored,
    # clamped into the grid, each a float32 operation
    k = torch.minimum(torch.floor((pts - lo_t) / cell_t).clamp_(min=0.0),
                      top).to(torch.int64)
    cid = (k[:, 2] * dims[1] + k[:, 1]) * dims[0] + k[:, 0]
    ncells = dims[0] * dims[1] * dims[2]
    order = torch.argsort(cid, stable=True)
    starts = torch.zeros(ncells + 1, dtype=torch.int32, device=dev)
    starts[1:] = torch.cumsum(torch.bincount(cid, minlength=ncells), 0)
    sorted4 = torch.zeros((p, 4), dtype=torch.float32, device=dev)
    sorted4[:, :3] = pts[order]
    return KnnGrid(sorted4, cid[order].to(torch.int32), starts, order,
                   tuple(lo), tuple(cell), margin, tuple(dims))


def search(g: KnnGrid, count_pairs: bool = False):
    """Kernel F's search over the CUDA grid ``g`` (``build_grid``): (the
    3-NN mean per point in the input order; with ``count_pairs`` the (P,)
    int32 candidate pairs each point evaluated, else None; a 0-d int32
    tensor, the points its second pass took). Not counted:
    ``mean_sq_dist_3nn`` is the entry; this is for measurements."""
    dev = g.points.device
    if dev.type != "cuda":
        raise TypeError(f"kernel F takes CUDA tensors, got {dev}")
    p = g.points.shape[0]
    out = torch.zeros(p, dtype=torch.float32, device=dev)
    pairs = (torch.zeros(p, dtype=torch.int32, device=dev)
             if count_pairs else None)
    scratch = torch.empty(p + 1, dtype=torch.int32, device=dev)
    if p == 0:
        return out, pairs, scratch[0].zero_()
    geom = (ctypes.c_double * 9)(*g.lo, *g.cell, *g.margin)
    dims = (ctypes.c_int * 3)(*g.dims)
    lib = _build.load("knn")
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (g.points.data_ptr(), g.cells.data_ptr(), g.starts.data_ptr(),
            g.order.data_ptr(), p, geom, dims, out.data_ptr())
    if count_pairs:
        rc = lib.knn_mean_sq_dist_pairs(*args, pairs.data_ptr(),
                                        scratch.data_ptr(), stream)
    else:
        rc = lib.knn_mean_sq_dist(*args, scratch.data_ptr(), stream)
    _build.check(rc, "knn_mean_sq_dist")
    return out, pairs, scratch[0]


def mean_sq_dist_3nn(points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """points (P, 3) → (P,) float32 mean of the squared distances to the 3
    nearest other points. A CUDA tensor goes through kernel F (its grid,
    then its search; or the call raises; ``chunk`` is the plain version's
    only); a CPU tensor takes the plain version."""
    if points.device.type == "cpu":
        return mean_sq_dist_3nn_plain(points, chunk)
    if points.device.type != "cuda":
        raise TypeError(f"mean_sq_dist_3nn takes CPU or CUDA tensors, got "
                        f"{points.device}")
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (P, 3), got {tuple(points.shape)}")
    if points.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=points.device)
    out = search(build_grid(points))[0]
    mean_sq_dist_3nn.launches += 1
    return out


mean_sq_dist_3nn.launches = 0   # kernel F launches in this process
