"""Dense reference rasterizer, the golden model (gslm_tpu/ops/rasterize_ref.py).

Every Gaussian is evaluated at every pixel — O(P·H·W) memory — so this is
for small scenes and tests only. Same semantics as the tile path, including
the tile-rect spatial gate."""

from __future__ import annotations

import torch

from gslm_tpu_torch.ops.composite import alpha_from_conic, composite_weights
from gslm_tpu_torch.ops.projection import TILE, Splats2D


def rasterize_ref(splats: Splats2D, height: int, width: int,
                  bg: torch.Tensor) -> dict:
    """Composite all splats over a (height, width) canvas. Returns
    dict(render (3,H,W), invdepth (1,H,W), t_final (H,W))."""
    depth_key = torch.where(splats.visible, splats.depth, torch.inf)
    order = torch.argsort(depth_key, stable=True)
    s = {k: getattr(splats, k)[order] for k in
         ("mean2d", "conic", "color", "opacity", "invdepth", "rect_min",
          "rect_max", "visible")}

    dev = splats.mean2d.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")

    tx = (torch.arange(width, device=dev) // TILE)[None, None, :]
    ty = (torch.arange(height, device=dev) // TILE)[None, :, None]
    rmin, rmax = s["rect_min"][:, :, None, None], s["rect_max"][:, :, None, None]
    in_rect = ((rmin[:, 0] <= tx) & (tx < rmax[:, 0])
               & (rmin[:, 1] <= ty) & (ty < rmax[:, 1]))
    gate = in_rect & s["visible"][:, None, None]

    alpha = alpha_from_conic(s["mean2d"], s["conic"], s["opacity"], px, py,
                             gate)
    weights, t_final = composite_weights(alpha)
    image = (torch.einsum("phw,pc->chw", weights, s["color"])
             + t_final[None] * bg[:, None, None])
    invd = torch.einsum("phw,p->hw", weights, s["invdepth"])[None]
    return {"render": image, "invdepth": invd, "t_final": t_final}
