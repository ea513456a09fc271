"""Mean squared distance to the 3 nearest neighbours (gslm_tpu/ops/knn.py),
which seeds the log-scales of a model made from a point cloud.

Chunked brute force on the points' device. The JAX version forms
‖a‖² + ‖b‖² − 2a·b, which cancels badly when the neighbours are close
next to the points' norms, and through a matmul it would depend on the
TF32 flags; here each squared distance is Σ(a − b)² in float32, exact to
the rounding of three differences, three squares and two adds. The four
smallest of a row include its own zero, which is dropped, as in JAX (a
duplicate point keeps its zero). Each row is computed on its own, so the
result does not depend on ``chunk``, the rows per distance block."""

from __future__ import annotations

import torch


def mean_sq_dist_3nn(points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """points (P, 3) float32 → (P,) mean of the squared distances to the 3
    nearest other points, on the points' device. A (chunk, P) block of
    distances is live at a time (512 MiB at the default and P = 131,072),
    with a second one and topk's workspace."""
    pts = points.to(torch.float32)
    p = pts.shape[0]
    chunk = max(1, min(p, int(chunk)))
    cols = [pts[:, i].contiguous() for i in range(3)]
    out = torch.empty(p, dtype=torch.float32, device=pts.device)
    with torch.no_grad():
        for lo in range(0, p, chunk):
            rows = pts[lo:lo + chunk]
            d2 = torch.sub(rows[:, 0:1], cols[0][None, :])
            d2.mul_(d2)
            t = torch.sub(rows[:, 1:2], cols[1][None, :])
            d2.add_(t.mul_(t))
            torch.sub(rows[:, 2:3], cols[2][None, :], out=t)
            d2.add_(t.mul_(t))
            top4 = torch.topk(d2, min(4, p), dim=1, largest=False,
                              sorted=True).values
            out[lo:lo + chunk] = (top4[:, 1:].sum(dim=1)) / 3.0
    return out
