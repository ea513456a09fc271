"""Per-Gaussian preprocess: projection, EWA 2D covariance, SH colour, tile
rects (gslm_tpu/ops/projection.py).

One vectorized pass over all P Gaussians of one camera. Semantics:
  - frustum cull at view z <= 0.2
  - projection via the full (proj @ view) matrix with a w + 1e-7 guard;
    NDC → pixel as ((ndc+1)*size - 1)/2
  - EWA: cov2d = J W Σ Wᵀ Jᵀ with the 1.3*tanfov clamp on t
  - low-pass dilation += 0.3 px on the diagonal; with antialiasing the
    opacity is rescaled by sqrt(det_orig / det_dilated)
  - radius = ceil(3 sqrt(λ_max)) of the dilated covariance
  - tile rect = the opacity-aware per-axis AABB of the alpha >= 1/255
    region, clamped to the grid
  - SH colour clamped at 0
The arithmetic is written term by term in the JAX package's order, so the
float fields agree to rounding and the integer rects exactly.

On CUDA tensors that need no autograd (``needs_autograd``) the whole pass
is kernel H (csrc/preprocess.cu), one launch, bit for bit the plain
graph's; every other call runs the plain graph below.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from gslm_tpu_torch import _build
from gslm_tpu_torch.models.cameras import Camera
from gslm_tpu_torch.models.gaussians import GaussianParams
from gslm_tpu_torch.ops.sh import MAX_SH_DEGREE, eval_sh, num_sh_coeffs
from gslm_tpu_torch.struct import Struct
from gslm_tpu_torch.utils.general import quat_normalize

TILE = 16
NEAR_CULL = 0.2
LOWPASS = 0.3

# Largest float32 below 2**31: the upper clamp of a float → int32 cast.
_I32_MAX_F = 2147483520.0


@dataclasses.dataclass
class Splats2D(Struct):
    """Projected per-Gaussian screen-space data (all (P, ...) tensors).
    Invisible Gaussians have ``visible=False`` and finite fields."""

    mean2d: torch.Tensor      # (P, 2) pixel coords
    conic: torch.Tensor       # (P, 3) upper-tri of inverse 2D covariance
    color: torch.Tensor       # (P, 3) RGB (>= 0)
    opacity: torch.Tensor     # (P,) effective opacity (AA-rescaled)
    depth: torch.Tensor       # (P,) view-space z (sort key)
    invdepth: torch.Tensor    # (P,) 1/z
    radius: torch.Tensor      # (P,) int32 pixel radius (0 = culled)
    rect_min: torch.Tensor    # (P, 2) int32 (tx0, ty0)
    rect_max: torch.Tensor    # (P, 2) int32 (tx1, ty1) exclusive
    tile_count: torch.Tensor  # (P,) int32 tiles touched
    visible: torch.Tensor     # (P,) bool


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float → int32 truncating toward zero, saturating out of range and
    mapping NaN to 0 (XLA's convert semantics; a bare ``.to(int32)`` of an
    out-of-range float is undefined)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=_I32_MAX_F, neginf=-2.0 ** 31)
    return torch.clamp(x, -2.0 ** 31, _I32_MAX_F).to(torch.int32)


def quad_min_rect(a, b, c, dx0, dx1, dy0, dy1):
    """Exact minimum of q(x,y)=a x² + 2b xy + c y² over the rectangle
    [dx0,dx1]×[dy0,dy1]: the centre if inside, else the least of the four
    edges' clamped parabolas."""
    inside = (dx0 <= 0) & (0 <= dx1) & (dy0 <= 0) & (0 <= dy1)
    ia = 1.0 / torch.clamp(a, min=1e-12)
    ic = 1.0 / torch.clamp(c, min=1e-12)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_x(dx):                      # x fixed, minimize over y
        return q(dx, torch.clamp(-b * dx * ic, dy0, dy1))

    def edge_y(dy):                      # y fixed, minimize over x
        return q(torch.clamp(-b * dy * ia, dx0, dx1), dy)

    m = torch.minimum(torch.minimum(edge_x(dx0), edge_x(dx1)),
                      torch.minimum(edge_y(dy0), edge_y(dy1)))
    return torch.where(inside, 0.0, m)


def compute_cov3d(scaling, rotation, scaling_modifier=1.0):
    """Upper-tri components of Σ = (R S)(R S)ᵀ as six (P,) tensors."""
    q = quat_normalize(rotation)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scaling * scaling_modifier
    v0, v1, v2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    return dict(
        xx=r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2,
        xy=r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2,
        xz=r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2,
        yy=r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2,
        yz=r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2,
        zz=r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2)


def preprocess(params: GaussianParams, camera: Camera, *,
               active_sh_degree: int, antialiasing: bool = False,
               scaling_modifier: float = 1.0,
               alive: torch.Tensor | None = None,
               mean2d_offset: torch.Tensor | None = None,
               color_override: torch.Tensor | None = None) -> Splats2D:
    """Project all Gaussians into one camera.

    ``color_override``: optional (P, 3) colours used in place of the SH
    evaluation (still sanitized of non-finite values).

    ``mean2d_offset``: optional (P, 2) zeros added to the projected mean in
    NDC-half units, scaled by (0.5 W, 0.5 H): the gradient carrier of the
    densification statistics (its cotangent is dL/dmean2d in the CUDA
    reference's convention).

    Differentiable in every parameter group (``preprocess_plain``). CUDA
    tensors that need no autograd (``needs_autograd``) take kernel H
    (``preprocess_cuda``), bit for bit the same fields; the other CUDA calls
    are counted in ``preprocess_plain_cuda_calls``."""
    global preprocess_plain_cuda_calls
    kw = dict(active_sh_degree=active_sh_degree, antialiasing=antialiasing,
              scaling_modifier=scaling_modifier, alive=alive,
              mean2d_offset=mean2d_offset, color_override=color_override)
    if params.xyz.device.type == "cuda":
        if not needs_autograd(_inputs(params, camera, mean2d_offset,
                                      color_override)):
            return preprocess_cuda(params, camera, **kw)
        preprocess_plain_cuda_calls += 1
    return preprocess_plain(params, camera, **kw)


def preprocess_plain(params: GaussianParams, camera: Camera, *,
                     active_sh_degree: int, antialiasing: bool = False,
                     scaling_modifier: float = 1.0,
                     alive: torch.Tensor | None = None,
                     mean2d_offset: torch.Tensor | None = None,
                     color_override: torch.Tensor | None = None) -> Splats2D:
    """``preprocess`` as a graph of PyTorch ops, differentiable in every
    parameter group. The rows of culled, dead and off-screen Gaussians are
    sanitized below without an infinite derivative on either side of a
    ``where``, so their gradients are finite and exactly zero, as in the
    JAX package."""
    xyz = params.xyz
    W, H = camera.width, camera.height
    fx = W / (2.0 * camera.tanfovx)
    fy = H / (2.0 * camera.tanfovy)

    def xform(m):
        """rows of (m @ [xyz, 1]) for a (rows, 4) slice m."""
        return [m[r, 0] * xyz[:, 0] + m[r, 1] * xyz[:, 1]
                + m[r, 2] * xyz[:, 2] + m[r, 3] for r in range(m.shape[0])]

    wv = camera.world_view
    tx_, ty_, tz_ = xform(wv[:3])
    hx, hy, hz, hw = xform(camera.full_proj)
    inv_w = 1.0 / (hw + 1e-7)
    p_x, p_y = hx * inv_w, hy * inv_w

    in_front = tz_ > NEAR_CULL
    tz = torch.where(in_front, tz_, 1.0)         # sanitized z

    mean2d = torch.stack([((p_x + 1.0) * W - 1.0) * 0.5,
                          ((p_y + 1.0) * H - 1.0) * 0.5], dim=-1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset * mean2d.new_tensor([0.5 * W, 0.5 * H])

    # --- EWA 2D covariance ---
    cov3d = compute_cov3d(params.get_scaling(), params.rotation,
                          scaling_modifier)
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    txz = torch.clamp(tx_ / tz, -limx, limx) * tz
    tyz = torch.clamp(ty_ / tz, -limy, limy) * tz

    j00 = fx / tz
    j02 = -(fx * txz) / (tz * tz)
    j11 = fy / tz
    j12 = -(fy * tyz) / (tz * tz)
    Wrot = wv[:3, :3]
    T0 = [j00 * Wrot[0, k] + j02 * Wrot[2, k] for k in range(3)]
    T1 = [j11 * Wrot[1, k] + j12 * Wrot[2, k] for k in range(3)]

    def sig_row(v):
        return [cov3d["xx"] * v[0] + cov3d["xy"] * v[1] + cov3d["xz"] * v[2],
                cov3d["xy"] * v[0] + cov3d["yy"] * v[1] + cov3d["yz"] * v[2],
                cov3d["xz"] * v[0] + cov3d["yz"] * v[1] + cov3d["zz"] * v[2]]

    U0 = sig_row(T0)
    U1 = sig_row(T1)
    c00 = U0[0] * T0[0] + U0[1] * T0[1] + U0[2] * T0[2]
    c01 = U0[0] * T1[0] + U0[1] * T1[1] + U0[2] * T1[2]
    c11 = U1[0] * T1[0] + U1[1] * T1[1] + U1[2] * T1[2]
    det_orig = c00 * c11 - c01 * c01
    c00d = c00 + LOWPASS
    c11d = c11 + LOWPASS
    det = c00d * c11d - c01 * c01
    det_ok = det > 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([c11d * inv_det, -c01 * inv_det, c00d * inv_det], -1)

    if antialiasing:
        conv_scale = torch.sqrt(torch.clamp(torch.where(
            det_ok, det_orig / torch.where(det_ok, det, 1.0), 1e-6), min=1e-6))
    else:
        conv_scale = torch.ones_like(det)

    opacity = torch.sigmoid(params.opacity[:, 0]) * conv_scale

    # --- screen radius & opacity-aware tile rect ---
    mid = 0.5 * (c00d + c11d)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam1))

    s2 = 2.0 * torch.log(torch.clamp(opacity * 255.0, min=1e-12))
    opa_vis = s2 > 0.0
    s2 = torch.clamp(s2, min=0.0)
    margin = 0.01
    rx = torch.sqrt(s2 * torch.clamp(c00d, min=0.0)) + margin
    ry = torch.sqrt(s2 * torch.clamp(c11d, min=0.0)) + margin

    ntx = -(-W // TILE)
    nty = -(-H // TILE)
    px, py = mean2d[:, 0], mean2d[:, 1]
    # truncate toward zero, then floor-divide (the JAX astype + //)
    tx0 = torch.clamp(torch.div(to_int32(px - rx), TILE, rounding_mode="floor"),
                      0, ntx)
    ty0 = torch.clamp(torch.div(to_int32(py - ry), TILE, rounding_mode="floor"),
                      0, nty)
    tx1 = torch.clamp(to_int32((px + rx + TILE - 1) / TILE), 0, ntx)
    ty1 = torch.clamp(to_int32((py + ry + TILE - 1) / TILE), 0, nty)
    tile_count = (torch.clamp(tx1 - tx0, min=0)
                  * torch.clamp(ty1 - ty0, min=0))

    visible = in_front & det_ok & opa_vis & (radius_f > 0) & (tile_count > 0)
    if alive is not None:
        visible = visible & alive
    tile_count = torch.where(visible, tile_count, 0)
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)

    # --- colour ---
    if color_override is not None:
        color = color_override
    else:
        dirs = xyz - camera.campos
        dirs = dirs / torch.clamp(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
        color = torch.clamp(
            eval_sh(active_sh_degree, params.get_features(), dirs) + 0.5,
            min=0.0)

    # --- sanitize invisible rows so gathers stay NaN-free ---
    vis_f = visible.to(mean2d.dtype)[:, None]
    mean2d = (torch.where(torch.isfinite(mean2d), mean2d, 0.0) * vis_f
              - (1.0 - vis_f) * 1e4)
    conic = torch.nan_to_num(conic, nan=0.0, posinf=0.0, neginf=0.0) * vis_f
    color = torch.nan_to_num(color, nan=0.0, posinf=0.0, neginf=0.0)
    opacity = torch.where(visible, opacity, 0.0)
    depth = torch.where(visible, tz, torch.inf)
    invdepth = torch.where(visible, 1.0 / tz, 0.0)

    return Splats2D(mean2d=mean2d, conic=conic, color=color, opacity=opacity,
                    depth=depth, invdepth=invdepth, radius=radius,
                    rect_min=torch.stack([tx0, ty0], -1).to(torch.int32),
                    rect_max=torch.stack([tx1, ty1], -1).to(torch.int32),
                    tile_count=tile_count.to(torch.int32), visible=visible)


# CUDA calls of ``preprocess`` that ran the plain graph (they needed
# autograd) in this process; ``preprocess_cuda.launches`` counts the rest
preprocess_plain_cuda_calls = 0


def _inputs(params, camera, mean2d_offset=None, color_override=None):
    """The float tensors ``preprocess`` reads, None where not given."""
    return (params.xyz, params.features_dc, params.features_rest,
            params.scaling, params.rotation, params.opacity,
            camera.world_view, camera.full_proj, camera.campos,
            camera.tanfovx, camera.tanfovy, mean2d_offset, color_override)


def needs_autograd(tensors) -> bool:
    """Whether a call on ``tensors`` (None entries skipped) needs the plain
    graph's autograd: grad mode is on and one of them requires grad, or one
    of them carries a forward-AD tangent at the current level. Kernel H
    computes values only, so it takes exactly the calls for which this is
    False."""
    ts = [t for t in tensors if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return True
    return any(fwAD.unpack_dual(t).tangent is not None for t in ts)


def preprocess_cuda(params: GaussianParams, camera: Camera, *,
                    active_sh_degree: int, antialiasing: bool = False,
                    scaling_modifier: float = 1.0,
                    alive: torch.Tensor | None = None,
                    mean2d_offset: torch.Tensor | None = None,
                    color_override: torch.Tensor | None = None) -> Splats2D:
    """``preprocess`` of CUDA tensors as kernel H (csrc/preprocess.cu): one
    launch, eleven fresh fields bit for bit the plain graph's, no autograd
    (the caller checks ``needs_autograd``). The SH colour is read from
    ``features_dc`` and ``features_rest`` as they are, with no
    concatenation. Raises ``TypeError`` on a dtype, device or shape the
    kernel cannot take, ``ValueError`` on an SH degree the coefficients do
    not hold."""
    xyz = params.xyz
    dev = xyz.device
    P = xyz.shape[0]
    deg = int(active_sh_degree)
    rest = params.features_rest
    if not 0 <= deg <= MAX_SH_DEGREE or num_sh_coeffs(deg) > 1 + rest.shape[1]:
        raise ValueError(f"SH degree {deg} needs {num_sh_coeffs(deg)} "
                         f"coefficients; the parameters hold "
                         f"{1 + rest.shape[1]} (degree at most "
                         f"{MAX_SH_DEGREE})")
    want = {"xyz": (xyz, (P, 3)), "scaling": (params.scaling, (P, 3)),
            "rotation": (params.rotation, (P, 4)),
            "opacity": (params.opacity, (P, 1)),
            "features_dc": (params.features_dc, (P, 1, 3)),
            "features_rest": (rest, (P, rest.shape[1], 3)),
            "world_view": (camera.world_view, (4, 4)),
            "full_proj": (camera.full_proj, (4, 4)),
            "campos": (camera.campos, (3,)),
            "tanfovx": (camera.tanfovx, ()), "tanfovy": (camera.tanfovy, ()),
            "mean2d_offset": (mean2d_offset, (P, 2)),
            "color_override": (color_override, (P, 3))}
    if alive is not None and (alive.dtype != torch.bool or alive.device != dev
                              or tuple(alive.shape) != (P,)):
        raise TypeError(f"preprocess_cuda needs alive as a bool (P,) tensor "
                        f"on {dev}, got {alive.dtype} {tuple(alive.shape)} "
                        f"on {alive.device}")
    ins = {}
    for name, (t, shape) in want.items():
        if t is None:
            continue
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or t.device != dev or tuple(t.shape) != shape):
            got = ((t.dtype, tuple(t.shape), t.device)
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise TypeError(f"preprocess_cuda needs {name} as a float32 "
                            f"{shape} tensor on {dev}, got {got}")
        # contiguous: a no-op on the main path; held until the launch
        ins[name] = t.contiguous()
    if rest.shape[1] > num_sh_coeffs(MAX_SH_DEGREE) - 1:
        raise TypeError(f"preprocess_cuda takes at most "
                        f"{num_sh_coeffs(MAX_SH_DEGREE) - 1} rows of "
                        f"features_rest, got {rest.shape[1]}")
    if alive is not None:
        alive = alive.contiguous()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # eleven allocations, freed one by one as the plain graph's are
    out = Splats2D(mean2d=empty(P, 2), conic=empty(P, 3), color=empty(P, 3),
                   opacity=empty(P), depth=empty(P), invdepth=empty(P),
                   radius=empty(P, dtype=torch.int32),
                   rect_min=empty(P, 2, dtype=torch.int32),
                   rect_max=empty(P, 2, dtype=torch.int32),
                   tile_count=empty(P, dtype=torch.int32),
                   visible=empty(P, dtype=torch.bool))
    if P:
        def ptr(name):
            return ins[name].data_ptr() if name in ins else None

        rc = _build.load("preprocess").preprocess(
            ptr("xyz"), ptr("scaling"), ptr("rotation"), ptr("opacity"),
            ptr("features_dc"), ptr("features_rest"), rest.shape[1],
            None if alive is None else alive.data_ptr(),
            ptr("color_override"), ptr("mean2d_offset"), ptr("world_view"),
            ptr("full_proj"), ptr("campos"), ptr("tanfovx"), ptr("tanfovy"),
            P, int(camera.width), int(camera.height), deg, int(antialiasing),
            float(scaling_modifier),
            *(getattr(out, f.name).data_ptr()
              for f in dataclasses.fields(Splats2D)),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "preprocess")
        preprocess_cuda.launches += 1
    return out


preprocess_cuda.launches = 0   # kernel H launches in this process
