"""What one view's render needs, counted from the inputs with the
reference's arithmetic (``reference.render``): Gaussians, visible splats,
AABB and live tile records, output pixels, and the (record, pixel) pairs
that contribute, past the 1/255 alpha gate and before the pixel's exit
(T < 1e-4), and the splats with at least one such pair. The roofline and
``step_mfu`` readers turn these counts into operations and bytes with the
fixed per-item costs of ``costs.py``; nothing here is read from the
program or from its kernels' code."""

from __future__ import annotations

import torch

from port_bench.reference.render import (MAX_ELEMS, TILE, _cdiv, chunk_alpha,
                                         composite_weights, project,
                                         tile_chunks, tile_lists)


@torch.no_grad()
def view_work(g: dict, cam: dict) -> dict:
    """Counts of one view of the groups ``g`` through camera ``cam``."""
    H, W = cam["height"], cam["width"]
    ntx, nty = _cdiv(W, TILE), _cdiv(H, TILE)
    sp = project(g, cam)
    order, rank, starts, ends, n_aabb = tile_lists(sp, ntx, nty)
    table = torch.cat([sp["mean2d"], sp["conic"], sp["opacity"][:, None],
                       sp["color"], sp["invdepth"][:, None]], dim=1)[order]
    records = table[rank].contiguous()
    counts = ends - starts
    pairs = 0
    used = torch.zeros(records.shape[0] + 1, dtype=torch.bool,
                       device=records.device)
    for t0, t1, s in tile_chunks(counts.cpu().numpy(), MAX_ELEMS):
        if s == 0:
            continue
        st, cn = starts[t0:t1], counts[t0:t1]
        alpha, _ = chunk_alpha(records, st, cn,
                               torch.arange(t0, t1, device=records.device),
                               s, ntx)
        weights, _ = composite_weights(alpha)
        hit = weights > 0                                   # (S, G, 256)
        pairs += int(hit.sum())
        slot = torch.arange(s, device=records.device)
        idx = torch.where(slot[:, None] < cn[None], st[None] + slot[:, None],
                          records.shape[0])                  # (S, G)
        used[idx[hit.any(dim=2)]] = True
    splats = int(torch.unique(rank[used[:-1]]).numel())
    return {"gaussians": int(g["xyz"].shape[0]),
            "visible": int(sp["visible"].sum()), "splats": splats,
            "records_aabb": n_aabb, "records": int(records.shape[0]),
            "pairs": pairs, "pixels": H * W}

