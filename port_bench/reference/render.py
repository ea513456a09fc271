"""Plain PyTorch reference of one view's render: projection, EWA covariance,
SH colour, tile rects, the culled tile front end, the record gather and the
closed-form front-to-back compositor with its backward.

A frozen copy of the port's plain versions (``ops/projection.py``,
``ops/sh.py``, ``ops/rasterize_tiled.py``, ``ops/composite.py`` and the
``*_plain`` compositors of ``ops/rasterize_cuda.py``), imports rewritten, so
a later change to the program cannot move its yardstick. It imports nothing
of the program: it works out projections, tile lists and records again from
the parameters and cameras the benchmark made.

``Precision`` is the control's hook: with ``bfloat16`` every stage's output
is stored in bfloat16 (rounded) and computed in float32 between, the step a
later change might take; with ``float32`` it is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 16
PIX = TILE * TILE
NEAR_CULL = 0.2
LOWPASS = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
IMG_ROWS = 5          # r, g, b, invdepth, t_final
_I32_MAX_F = 2147483520.0

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


class Precision:
    """Rounds a stage's output to ``dtype`` and back to float32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32 or not t.is_floating_point():
            return t
        return t.to(self.dtype).to(torch.float32)


FP32 = Precision()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    x = torch.nan_to_num(x, nan=0.0, posinf=_I32_MAX_F, neginf=-2.0 ** 31)
    return torch.clamp(x, -2.0 ** 31, _I32_MAX_F).to(torch.int32)


def quad_min_rect(a, b, c, dx0, dx1, dy0, dy1):
    """Exact minimum of a x² + 2b xy + c y² over [dx0,dx1]×[dy0,dy1]."""
    inside = (dx0 <= 0) & (0 <= dx1) & (dy0 <= 0) & (0 <= dy1)
    ia = 1.0 / torch.clamp(a, min=1e-12)
    ic = 1.0 / torch.clamp(c, min=1e-12)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_x(dx):
        return q(dx, torch.clamp(-b * dx * ic, dy0, dy1))

    def edge_y(dy):
        return q(torch.clamp(-b * dy * ia, dx0, dx1), dy)

    m = torch.minimum(torch.minimum(edge_x(dx0), edge_x(dx1)),
                      torch.minimum(edge_y(dy0), edge_y(dy1)))
    return torch.where(inside, 0.0, m)


def sh_color_deg3(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH of degree 3: sh (P, 16, 3) at unit dirs (P, 3) → (P, 3)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    cols = [torch.full_like(x, C0), -C1 * y, C1 * z, -C1 * x,
            C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz, C2[4] * (xx - yy),
            C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy)]
    basis = torch.stack(cols, dim=-1)
    return torch.sum(basis[..., None] * sh[..., :16, :], dim=-2)


def project(g: dict, cam: dict, q: Precision = FP32) -> dict:
    """Project every Gaussian of ``g`` (raw groups: xyz, features_dc,
    features_rest, scaling (log), rotation (wxyz), opacity (logit)) into
    ``cam`` (world_view, full_proj (4, 4), campos (3,), tanfovx, tanfovy
    floats, height, width). Returns the splat fields."""
    xyz = q(g["xyz"])
    W, H = cam["width"], cam["height"]
    tanx, tany = cam["tanfovx"], cam["tanfovy"]
    fx = W / (2.0 * tanx)
    fy = H / (2.0 * tany)

    def xform(m):
        return [m[r, 0] * xyz[:, 0] + m[r, 1] * xyz[:, 1]
                + m[r, 2] * xyz[:, 2] + m[r, 3] for r in range(m.shape[0])]

    wv = cam["world_view"]
    tx_, ty_, tz_ = xform(wv[:3])
    hx, hy, hz, hw = xform(cam["full_proj"])
    inv_w = 1.0 / (hw + 1e-7)
    p_x, p_y = hx * inv_w, hy * inv_w
    in_front = tz_ > NEAR_CULL
    tz = torch.where(in_front, tz_, 1.0)
    mean2d = torch.stack([((p_x + 1.0) * W - 1.0) * 0.5,
                          ((p_y + 1.0) * H - 1.0) * 0.5], dim=-1)

    rot = q(g["rotation"])
    rq = rot / torch.clamp(torch.linalg.vector_norm(rot, dim=-1, keepdim=True),
                           min=1e-12)
    w, x, y, z = rq[:, 0], rq[:, 1], rq[:, 2], rq[:, 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = torch.exp(q(g["scaling"]))
    v0, v1, v2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    cxx = r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2
    cxy = r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2
    cxz = r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2
    cyy = r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2
    cyz = r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2
    czz = r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2

    limx, limy = 1.3 * tanx, 1.3 * tany
    txz = torch.clamp(tx_ / tz, -limx, limx) * tz
    tyz = torch.clamp(ty_ / tz, -limy, limy) * tz
    j00 = fx / tz
    j02 = -(fx * txz) / (tz * tz)
    j11 = fy / tz
    j12 = -(fy * tyz) / (tz * tz)
    Wr = wv[:3, :3]
    T0 = [j00 * Wr[0, k] + j02 * Wr[2, k] for k in range(3)]
    T1 = [j11 * Wr[1, k] + j12 * Wr[2, k] for k in range(3)]

    def sig_row(v):
        return [cxx * v[0] + cxy * v[1] + cxz * v[2],
                cxy * v[0] + cyy * v[1] + cyz * v[2],
                cxz * v[0] + cyz * v[1] + czz * v[2]]

    U0, U1 = sig_row(T0), sig_row(T1)
    c00 = U0[0] * T0[0] + U0[1] * T0[1] + U0[2] * T0[2]
    c01 = U0[0] * T1[0] + U0[1] * T1[1] + U0[2] * T1[2]
    c11 = U1[0] * T1[0] + U1[1] * T1[1] + U1[2] * T1[2]
    c00d = c00 + LOWPASS
    c11d = c11 + LOWPASS
    det = c00d * c11d - c01 * c01
    det_ok = det > 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([c11d * inv_det, -c01 * inv_det, c00d * inv_det], -1)
    opacity = torch.sigmoid(q(g["opacity"])[:, 0])

    mid = 0.5 * (c00d + c11d)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam1))
    s2 = 2.0 * torch.log(torch.clamp(opacity * 255.0, min=1e-12))
    opa_vis = s2 > 0.0
    s2 = torch.clamp(s2, min=0.0)
    rx = torch.sqrt(s2 * torch.clamp(c00d, min=0.0)) + 0.01
    ry = torch.sqrt(s2 * torch.clamp(c11d, min=0.0)) + 0.01
    ntx, nty = _cdiv(W, TILE), _cdiv(H, TILE)
    px, py = mean2d[:, 0], mean2d[:, 1]
    tx0 = torch.clamp(torch.div(to_int32(px - rx), TILE,
                                rounding_mode="floor"), 0, ntx)
    ty0 = torch.clamp(torch.div(to_int32(py - ry), TILE,
                                rounding_mode="floor"), 0, nty)
    tx1 = torch.clamp(to_int32((px + rx + TILE - 1) / TILE), 0, ntx)
    ty1 = torch.clamp(to_int32((py + ry + TILE - 1) / TILE), 0, nty)
    tile_count = torch.clamp(tx1 - tx0, min=0) * torch.clamp(ty1 - ty0, min=0)
    visible = (in_front & det_ok & opa_vis & (radius_f > 0)
               & (tile_count > 0))
    tile_count = torch.where(visible, tile_count, 0)

    dirs = xyz - cam["campos"]
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    sh = torch.cat([q(g["features_dc"]), q(g["features_rest"])], dim=1)
    color = torch.clamp(sh_color_deg3(sh, dirs) + 0.5, min=0.0)

    vis_f = visible.to(mean2d.dtype)[:, None]
    mean2d = (torch.where(torch.isfinite(mean2d), mean2d, 0.0) * vis_f
              - (1.0 - vis_f) * 1e4)
    conic = torch.nan_to_num(conic, nan=0.0, posinf=0.0, neginf=0.0) * vis_f
    color = torch.nan_to_num(color, nan=0.0, posinf=0.0, neginf=0.0)
    return dict(mean2d=q(mean2d), conic=q(conic), color=q(color),
                opacity=q(torch.where(visible, opacity, 0.0)),
                depth=q(torch.where(visible, tz, torch.inf)),
                invdepth=q(torch.where(visible, 1.0 / tz, 0.0)),
                rect_min=torch.stack([tx0, ty0], -1).to(torch.int32),
                rect_max=torch.stack([tx1, ty1], -1).to(torch.int32),
                tile_count=tile_count.to(torch.int32), visible=visible)


def cell_masks(sp: dict, view_rows: int, cwb: int):
    """Per-Gaussian 8×8-cell survival masks of the exact ellipse–tile cull
    (three packed int32 words, the packed cell size, the live tile count)."""
    x0r, y0r = sp["rect_min"][:, 0], sp["rect_min"][:, 1]
    x1r, y1r = sp["rect_max"][:, 0], sp["rect_max"][:, 1]
    wr = torch.clamp(x1r - x0r, min=1)
    hr = torch.clamp(y1r - y0r, min=1)
    cw = (wr + 7) >> 3
    ch = (hr + 7) >> 3
    y0loc = torch.remainder(y0r, view_rows)
    mx, my = sp["mean2d"][:, 0].detach(), sp["mean2d"][:, 1].detach()
    conic = sp["conic"].detach()
    qa = torch.clamp(conic[:, 0], min=1e-12)
    qb = conic[:, 1]
    qc = torch.clamp(conic[:, 2], min=1e-12)
    s2 = 2.0 * torch.log(torch.clamp(sp["opacity"].detach() * 255.0,
                                     min=1e-12))
    ft = float(TILE)
    words = [torch.zeros_like(x0r) for _ in range(3)]
    nlive = torch.zeros_like(x0r)
    for b in range(64):
        cy_, cx_ = b >> 3, b & 7
        ax0 = cx_ * cw
        ax1 = torch.minimum(ax0 + cw, wr)
        ay0 = cy_ * ch
        ay1 = torch.minimum(ay0 + ch, hr)
        nx = torch.clamp(ax1 - ax0, min=0)
        ny = torch.clamp(ay1 - ay0, min=0)
        qmin = quad_min_rect(qa, qb, qc,
                             (x0r + ax0).float() * ft - mx,
                             (x0r + ax1).float() * ft - 1.0 - mx,
                             (y0loc + ay0).float() * ft - my,
                             (y0loc + ay1).float() * ft - 1.0 - my)
        keep = (nx > 0) & (ny > 0) & (qmin * (1.0 - 1e-4) <= s2 + 1e-3)
        wi, sh = (0, b) if b < 22 else ((1, b - 22) if b < 44 else (2, b - 44))
        words[wi] = words[wi] | (keep.to(torch.int32) << sh)
        nlive = nlive + torch.where(keep, nx * ny, 0)
    nlive = torch.where(sp["tile_count"] > 0, nlive, 0)
    return words[0], words[1], words[2], (ch << cwb) | cw, nlive


@torch.no_grad()
def tile_lists(sp: dict, ntx: int, nty: int):
    """Stages 1-3 of the tile pipeline with the exact cull: ``(order (P,),
    rank (n,), starts, ends (ntiles,), n_aabb)``; tile t's records are
    ``rank[starts[t]:ends[t]]`` of the depth-sorted table, depth ascending,
    ties by index."""
    P = sp["mean2d"].shape[0]
    dev = sp["mean2d"].device
    depth_key = torch.where(sp["visible"], sp["depth"].detach(), torch.inf)
    order = torch.argsort(depth_key, stable=True)
    counts = sp["tile_count"][order].long()
    x0 = sp["rect_min"][order, 0].long()
    x1 = sp["rect_max"][order, 0].long()
    y0 = sp["rect_min"][order, 1].long()
    offsets = torch.cumsum(counts, 0) - counts
    rank_e = torch.repeat_interleave(torch.arange(P, device=dev), counts)
    r = torch.arange(rank_e.shape[0], device=dev) - offsets[rank_e]
    w_e = torch.clamp(x1 - x0, min=1)[rank_e]
    dy = torch.div(r, w_e, rounding_mode="floor")
    dx = r - dy * w_e
    tile = (y0 * ntx + x0)[rank_e] + dy * ntx + dx
    cwb = max(_cdiv(ntx, 8).bit_length(), 1)
    m0, m1, m2, cwch, _ = cell_masks(sp, nty, cwb)
    m0, m1, m2, cwch = (v[order].long()[rank_e] for v in (m0, m1, m2, cwch))
    cw_e = torch.clamp(cwch & ((1 << cwb) - 1), min=1)
    ch_e = torch.clamp(cwch >> cwb, min=1)
    cb = (torch.clamp(torch.div(dy, ch_e, rounding_mode="floor"), 0, 7) * 8
          + torch.clamp(torch.div(dx, cw_e, rounding_mode="floor"), 0, 7))
    word = torch.where(cb < 22, m0, torch.where(cb < 44, m1, m2))
    shv = torch.where(cb < 22, cb, torch.where(cb < 44, cb - 22, cb - 44))
    live = ((word >> shv) & 1) > 0
    tile, rank_e = tile[live], rank_e[live]
    key, _ = torch.sort((tile << 32) | rank_e)
    rank = key & 0xFFFFFFFF
    bounds = (torch.arange(ntx * nty, device=dev) + 1) << 32
    ends = torch.searchsorted(key.contiguous(), bounds, right=False)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    return order, rank, starts, ends, int(counts.sum())


def tile_chunks(counts: np.ndarray, max_elems: int):
    """Consecutive tile ranges ``(t0, t1, longest segment)`` of at most
    ``max_elems`` (record, pixel) pairs each (one tile at least)."""
    ntiles = counts.shape[0]
    t0 = 0
    while t0 < ntiles:
        t1, s_max = t0, 0
        while t1 < ntiles:
            s_new = max(s_max, int(counts[t1]))
            if t1 > t0 and (t1 - t0 + 1) * s_new * PIX > max_elems:
                break
            s_max, t1 = s_new, t1 + 1
        yield t0, t1, s_max
        t0 = t1


def tile_pixels(tiles: torch.Tensor, ntx: int):
    lin = torch.arange(PIX, device=tiles.device)
    tx = (tiles % ntx) * TILE
    ty = torch.div(tiles, ntx, rounding_mode="floor") * TILE
    return ((tx[:, None] + lin % TILE).float(),
            (ty[:, None] + lin // TILE).float())


def chunk_alpha(records, starts, counts, tiles, S, ntx):
    """Alphas of G tiles over S record slots, front to back: (S, G, 256),
    differentiable in ``records``, and the gathered records (G, S, 10)."""
    slot = torch.arange(S, device=records.device)
    valid = slot[None] < counts[:, None]
    idx = torch.clamp(starts[:, None] + slot[None], 0, records.shape[0] - 1)
    rec = records[idx]
    px, py = tile_pixels(tiles, ntx)
    dx = rec[..., 0, None] - px[:, None]
    dy = rec[..., 1, None] - py[:, None]
    power = (-0.5 * (rec[..., 2, None] * dx * dx + rec[..., 4, None] * dy * dy)
             - rec[..., 3, None] * dx * dy)
    gate = valid[..., None] & (power <= 0.0)
    power = torch.where(gate, power, -100.0)
    raw = rec[..., 5, None] * torch.exp(power)
    alpha = raw + (torch.clamp(raw, max=ALPHA_MAX) - raw).detach()
    return alpha.transpose(0, 1), rec


def composite_weights(alpha):
    """alpha (N, ...) front to back → (weights (N, ...), t_final (...))."""
    contrib = alpha >= ALPHA_MIN
    a = torch.where(contrib, alpha, 0.0)
    log_step = torch.log1p(-a)
    log_t_after = torch.cumsum(log_step, dim=0)
    t_after = torch.exp(log_t_after)
    t_before = torch.exp(log_t_after - log_step)
    ok = contrib & (t_after >= T_EPS)
    weights = torch.where(ok, a * t_before, 0.0)
    fail = contrib & (t_after < T_EPS)
    any_fail = torch.any(fail, dim=0)
    t_frozen = torch.amax(torch.where(fail, t_before, 0.0), dim=0)
    t_final = torch.where(any_fail, t_frozen, t_after[-1])
    return weights, t_final


def composite_chunk(records, starts, counts, tiles, S, ntx):
    """Rows r, g, b, invdepth, t_final of G tiles: (G, 5, 256)."""
    alpha, rec = chunk_alpha(records, starts, counts, tiles, S, ntx)
    weights, t_final = composite_weights(alpha)
    feat = rec[..., 6:10].transpose(0, 1)
    acc = torch.cumsum(weights[..., None] * feat[:, :, None], dim=0)[-1]
    return torch.cat([acc.permute(0, 2, 1), t_final[:, None]], dim=1)


MAX_ELEMS = 1 << 25


class Composite(torch.autograd.Function):
    """The closed-form compositor over every tile's segment, in chunks of
    at most ``MAX_ELEMS`` pairs; its backward recomputes each chunk under
    autograd, so memory stays bounded."""

    @staticmethod
    def forward(ctx, records, starts, counts, ntx):
        ntiles = counts.shape[0]
        out = torch.zeros(ntiles, IMG_ROWS, PIX, device=records.device)
        out[:, 4] = 1.0
        cnt = counts.cpu().numpy()
        ctx.chunks = list(tile_chunks(cnt, MAX_ELEMS))
        ctx.ntx = ntx
        for t0, t1, s in ctx.chunks:
            if s > 0:
                out[t0:t1] = composite_chunk(
                    records, starts[t0:t1], counts[t0:t1],
                    torch.arange(t0, t1, device=records.device), s, ntx)
        ctx.save_for_backward(records, starts, counts)
        return out

    @staticmethod
    def backward(ctx, gout):
        records, starts, counts = ctx.saved_tensors
        drec = torch.zeros_like(records)
        st = starts.cpu().numpy()
        cn = counts.cpu().numpy()
        for t0, t1, s in ctx.chunks:
            if s == 0:
                continue
            lo = int(st[t0:t1].min())
            hi = int((st[t0:t1] + cn[t0:t1]).max())
            with torch.enable_grad():
                sub = records[lo:hi].detach().requires_grad_(True)
                out = composite_chunk(
                    sub, starts[t0:t1] - lo, counts[t0:t1],
                    torch.arange(t0, t1, device=records.device), s, ctx.ntx)
                (d,) = torch.autograd.grad(out, sub, gout[t0:t1])
            drec[lo:hi] += d
        return drec, None, None, None


def render(g: dict, cam: dict, bg: torch.Tensor, q: Precision = FP32):
    """One view: ``(image (3, H, W) clamped to [0, 1], info)``,
    differentiable in every group of ``g``; info holds the AABB and live
    record counts and the longest tile segment."""
    H, W = cam["height"], cam["width"]
    ntx, nty = _cdiv(W, TILE), _cdiv(H, TILE)
    sp = project(g, cam, q)
    order, rank, starts, ends, n_aabb = tile_lists(sp, ntx, nty)
    table = torch.cat([sp["mean2d"], sp["conic"], sp["opacity"][:, None],
                       sp["color"], sp["invdepth"][:, None]], dim=1)[order]
    records = q(table[rank].contiguous())
    counts = ends - starts
    tiles = Composite.apply(records, starts, counts, ntx)
    canvas = (tiles.reshape(nty, ntx, IMG_ROWS, TILE, TILE)
              .permute(2, 0, 3, 1, 4)
              .reshape(IMG_ROWS, nty * TILE, ntx * TILE)[:, :H, :W])
    image = q(canvas[0:3] + canvas[4:5] * bg[:, None, None])
    info = {"n_aabb": n_aabb, "n_live": int(records.shape[0]),
            "max_tile_load": int(counts.max())}
    return torch.clamp(image, 0.0, 1.0), info


def camera_dict(world_view, full_proj, campos, tanfovx: float,
                tanfovy: float, height: int, width: int, device) -> dict:
    """A reference camera from the benchmark's own numpy matrices."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return dict(world_view=t(world_view), full_proj=t(full_proj),
                campos=t(campos), tanfovx=t(tanfovx), tanfovy=t(tanfovy),
                height=int(height), width=int(width))
