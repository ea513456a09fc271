"""Kernel C's patch design (csrc/composite_bwd.cu) on the CPU.

Kernel C runs only on the card. Here its algorithm is mirrored in float32
numpy: kernel A's 8x4 warp patches (``PATCH_PIXELS``), the per-record patch
mask (``patch_masks``), each warp starting at the largest exit position of
its own lanes, the reverse walk from kernel A's exit state with the suffix
accumulator, and the per-record sum in the kernel's order: per warp, a
record no lane contributes to adds nothing, the others are summed by the
xor butterfly 16, 8, 4, 2, 1 (own + partner at each level, what the
reduce-scatter computes per field); then the warps' sums in warp order from 0. Cases: a random scene, a
dense one (segments of more than 256 records, pixels that exit), a 72-row
view (partial tiles), and the adversarial records of tests/patch_cases.py.

- With the mask and per-warp starts and without them (every warp walks
  every record below the block's largest exit) the mirror is bitwise
  equal: a pair whose bit is clear, or past its pixel's exit, contributes
  nothing.
- The mirror equals ``composite_tiles_bwd_plain`` at the knife-edge bound
  of the parity tests per field, relative to max |plain| (mean |Δ| <
  2e-4·scale, at most 1 % above 1e-3·scale), with and without depth_grad,
  and, on the random scene, JAX's Pallas VJP in interpret mode per splat
  field at the same bound (the mirror's record cotangents reach the splats
  through the port's record gather).

    python -m pytest tests/test_torch_bwd_patch.py -q
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu.ops.projection import Splats2D as JSplats2D
from gslm_tpu.ops.rasterize_pallas import rasterize_pallas as j_rasterize_pallas
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu_torch.models.cameras import camera_from_arrays
from gslm_tpu_torch.ops.projection import Splats2D, preprocess
from gslm_tpu_torch.ops.rasterize_cuda import (PATCH_PIXELS, PIX,
                                               composite_tiles_bwd,
                                               composite_tiles_bwd_plain,
                                               composite_tiles_bwd_unmasked,
                                               composite_tiles_plain,
                                               patch_masks, rect_gate,
                                               tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.utils.synthetic import make_camera, random_gaussians
# pytest puts tests/ on sys.path; an installed ``tests`` package can shadow
# the name ``tests.patch_cases``
from patch_cases import adversarial_records
from test_torch_fwd_patch import BG, CAP, _kernel_a

FIELDS = ("mean2d", "conic", "color", "opacity", "invdepth")


def _warp_sum(v, act):
    """(10, ..., 8, 32) terms, (..., 8, 32) contributing lanes → (10, ...,
    8) warp sums through the xor butterfly 16, 8, 4, 2, 1 and (..., 8)
    which warps wrote (those with a contributing lane)."""
    lane = np.arange(32)
    x = np.where(act, v, np.float32(0))
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lane ^ o]
    return x[..., 0], act.any(axis=-1)


def segments(rec, starts, counts, ntx, view_rows, masked, rects=None):
    """Every tile's segment padded to the longest, (T, S, 10), its indices
    (T, S) and its patch masks (T, S): ``patch_masks`` (0 outside the rect
    gate with ``rects``), or without ``masked`` all bits (0 outside the rect
    gate)."""
    S = max(int(counts.max()), 1)
    slot = np.arange(S)
    idx = np.minimum(starts[:, None] + slot, len(rec) - 1)
    seg = rec[idx]
    tiles = torch.arange(len(counts))
    r = None if rects is None else torch.from_numpy(rects[idx])
    if masked:
        with np.errstate(invalid="ignore", over="ignore"):
            bits = patch_masks(torch.from_numpy(seg), tiles, ntx, view_rows,
                               r).numpy()
    else:
        bits = np.full(idx.shape, 0xFF)
        if r is not None:
            bits = np.where(rect_gate(r, tiles, ntx, view_rows).numpy(),
                            bits, 0)
    return seg, idx, bits


def _tile_sums(rec, starts, counts, ntx, view_rows, gtiles, state,
               depth_grad=True, masked=True, steps=None, rects=None):
    """Kernel C's walk in float32 numpy (composite_bwd_tile.cuh), all tiles
    at once, record slot by slot from the last → (sums (T, S, 10): each
    tile's per-record sum over its pixels, wrote (T, S): whether a warp
    wrote a partial of it, n_eff (T,): the tile's largest exit position).
    Thread k of a tile is pixel PATCH_PIXELS[k]; ``masked=False``: no patch
    mask and every warp starts at its block's largest exit position; with
    ``rects`` a record outside the tile's rect gate has mask 0 (kernel D).
    ``steps`` (a list): gets the number of (record, warp) steps walked."""
    f32 = np.float32
    T = len(counts)
    tiles = np.arange(T)[:, None]
    px = ((tiles % ntx) * 16 + PATCH_PIXELS % 16).astype(f32)   # (T, 256)
    py = (((tiles // ntx) % view_rows) * 16
          + PATCH_PIXELS // 16).astype(f32)
    g = gtiles[:, :, PATCH_PIXELS].astype(f32).transpose(1, 0, 2)
    g_i = g[3] if depth_grad else np.zeros_like(g[3])
    lsum = state[:, 0][:, PATCH_PIXELS].astype(f32)
    exit_pos = np.clip(state[:, 1][:, PATCH_PIXELS].astype(np.int64), 0,
                       counts[:, None])
    warp_eff = exit_pos.reshape(T, 8, 32).max(axis=-1)          # (T, 8)
    n_eff = warp_eff.max(axis=-1)
    if not masked:
        warp_eff[:] = n_eff[:, None]
    seg, _, bits = segments(rec, starts, counts, ntx, view_rows, masked,
                            rects)
    S = seg.shape[1]
    sums = np.zeros((T, S, 10), f32)
    wrote_any = np.zeros((T, S), bool)
    s_acc = g[4] * np.exp(lsum)
    n_steps = 0
    for i in range(int(n_eff.max()) - 1, -1, -1):
        r = seg[:, i, :, None]                                   # (T, 10, 1)
        walk = (i < warp_eff) & ((bits[:, i, None] >> np.arange(8)) & 1 > 0)
        n_steps += int(walk.sum())
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            dx, dy = r[:, 0] - px, r[:, 1] - py
            power = (f32(-0.5) * (r[:, 2] * dx * dx + r[:, 4] * dy * dy)
                     - r[:, 3] * dx * dy)
            expp = np.exp(np.minimum(power, f32(0)))
            a_raw = r[:, 5] * expp
            a = np.minimum(a_raw, f32(0.99))
            act = (np.repeat(walk, 32, axis=1) & (i < exit_pos)
                   & (power <= 0) & (a >= f32(1 / 255)))
            l_before = np.minimum(lsum - np.log1p(-a), f32(0))
            Tb = np.exp(l_before)
            w = a * Tb
            dw = r[:, 6] * g[0] + r[:, 7] * g[1] + r[:, 8] * g[2]
            if depth_grad:
                dw = dw + r[:, 9] * g_i
            da = dw * Tb - s_acc / (f32(1) - a)
            dpow = da * a_raw
            terms = np.stack([dpow * -(r[:, 2] * dx + r[:, 3] * dy),
                              dpow * -(r[:, 4] * dy + r[:, 3] * dx),
                              dpow * (f32(-0.5) * dx * dx),
                              dpow * (-dx * dy),
                              dpow * (f32(-0.5) * dy * dy), da * expp,
                              w * g[0], w * g[1], w * g[2], w * g_i])
            s_acc = np.where(act, s_acc + dw * w, s_acc)
        lsum = np.where(act, l_before, lsum)
        part, wrote = _warp_sum(terms.reshape(10, T, 8, 32).astype(f32),
                                act.reshape(T, 8, 32))
        acc = np.zeros((10, T), f32)
        for wp in range(8):
            acc = np.where(wrote[:, wp], acc + part[:, :, wp], acc)
        sums[:, i] = acc.T
        wrote_any[:, i] = wrote.any(axis=1)
    if steps is not None:
        steps.append(n_steps)
    return sums, wrote_any, n_eff


def _kernel_c(rec, starts, counts, ntx, view_rows, gtiles, state,
              depth_grad=True, masked=True, steps=None):
    """Kernel C in float32 numpy → drec (L, 10): ``_tile_sums`` written to
    each tile's rows below its largest exit, zeros past it."""
    sums, _, n_eff = _tile_sums(rec, starts, counts, ntx, view_rows, gtiles,
                                state, depth_grad, masked, steps)
    drec = np.zeros_like(rec, dtype=np.float32)
    for i in range(int(n_eff.max())):
        live = i < n_eff
        drec[starts[live] + i] = sums[live, i]
    return drec


def port_case(name):
    """(port splat fields as a dict, h, w, bucket) of a named case, the
    scenes of tests/test_torch_fwd_patch.py through the port's own
    preprocess: "random" (300 Gaussians), "dense" (400, spread 0.4, larger:
    segments of more than 256 records, pixels that exit), "partial" (a
    72-row view), "bucket2" and "bucket4" (the dense scene)."""
    n, spread, scales = 300, 1.0, (-3.5, -2.0)
    if name in ("dense", "bucket2", "bucket4"):
        n, spread, scales = 400, 0.4, (-3.0, -1.5)
    h = 72 if name == "partial" else 64
    params = random_gaussians(np.random.default_rng(0), n=n, spread=spread,
                              scale_range=scales, device="cpu")
    meta = make_camera(height=h, width=96, radius=4.0)
    cam = camera_from_arrays(meta.R, meta.T, meta.fovx, meta.fovy, 96, h,
                             device="cpu")
    with torch.no_grad():
        sp = preprocess(params, cam, active_sh_degree=3)
    return ({k: v.detach().clone() for k, v in vars(sp).items()}, h, 96,
            int(name[-1]) if name.startswith("bucket") else 1)


def to_jax(sp: dict):
    """The port's splat fields as JAX ``Splats2D``."""
    return JSplats2D(**{k: jnp.asarray(v.detach().numpy())
                        for k, v in sp.items()})


def _inputs(name, seed=2):
    """(TileRecords, ntx, nty, h, w, splat fields, the plain forward's tiles,
    a seeded image cotangent (ntiles, 5, 256))."""
    sp, h, w, _ = port_case(name)
    ntx, nty = -(-w // 16), -(-h // 16)
    tr = tile_records(Splats2D(**sp), ntx, nty, RasterConfig(dup_capacity=CAP))
    tiles, _ = composite_tiles_plain(tr.records, tr.starts, tr.counts, ntx,
                                     nty)
    gt = np.random.default_rng(seed).normal(
        0, 1, (len(tr.counts), 5, PIX)).astype(np.float32)
    return tr, ntx, nty, h, w, sp, tiles, gt


def knife_edge(got, want):
    scale = np.abs(want).max() + 1e-12
    d = np.abs(got - want)
    return d.mean() < 2e-4 * scale and (d > 1e-3 * scale).mean() <= 0.01


@pytest.mark.parametrize("name", ["random", "dense", "partial"])
def test_mirror_mask_is_exact_and_matches_plain(name):
    tr, ntx, nty, h, w, sp, tiles, gt = _inputs(name)
    rec, st, cn = tr.records.numpy(), tr.starts.numpy(), tr.counts.numpy()
    state = tiles[:, 5:].numpy()
    if name == "dense":   # deep segments, and pixels that exit
        assert cn.max() > PIX and (state[:, 1] < cn[:, None]).sum() > 100
    for depth_grad in (True, False):
        steps = []
        got = _kernel_c(rec, st, cn, ntx, nty, gt, state, depth_grad,
                        steps=steps)
        ref = _kernel_c(rec, st, cn, ntx, nty, gt, state, depth_grad,
                        masked=False, steps=steps)
        assert np.array_equal(got, ref)
        assert 0 < steps[0] < 0.8 * steps[1], steps   # the design skips
        want = composite_tiles_bwd_plain(tr.records, tr.starts, tr.counts,
                                         ntx, nty, torch.from_numpy(gt),
                                         depth_grad).numpy()
        for f in range(10):
            assert knife_edge(got[:, f], want[:, f]), (name, depth_grad, f)
        if not depth_grad:
            assert not got[:, 9].any()


def test_mirror_matches_pallas_vjp():
    """The mirror's record cotangents, through the port's record gather,
    against JAX's Pallas VJP in interpret mode per splat field."""
    tr, ntx, nty, h, w, sp, tiles, _ = _inputs("random")
    js = to_jax(sp)
    rng = np.random.default_rng(1)
    u = rng.normal(0, 1, (3, h, w)).astype(np.float32)
    ui = rng.normal(0, 1, (1, h, w)).astype(np.float32)

    def j_loss(*fields):
        out = j_rasterize_pallas(
            js.replace(**dict(zip(FIELDS, fields))), h, w, jnp.asarray(BG),
            JRasterConfig(dup_capacity=CAP), interpret=True, mode="vjp")
        return jnp.sum(out["render"] * u) + jnp.sum(out["invdepth"] * ui)

    want = jax.grad(j_loss, argnums=tuple(range(len(FIELDS))))(
        *[getattr(js, k) for k in FIELDS])
    # the image cotangent in tile layout: rgb u, invdepth ui, t_final u.bg
    canvas = np.zeros((5, nty * 16, ntx * 16), np.float32)
    canvas[:3, :h, :w] = u
    canvas[3, :h, :w] = ui[0]
    canvas[4, :h, :w] = np.tensordot(BG, u, axes=1)
    gt = (canvas.reshape(5, nty, 16, ntx, 16).transpose(1, 3, 0, 2, 4)
          .reshape(nty * ntx, 5, PIX))
    drec = _kernel_c(tr.records.numpy(), tr.starts.numpy(),
                     tr.counts.numpy(), ntx, nty, gt, tiles[:, 5:].numpy())
    leaves = [sp[k].requires_grad_(True) for k in FIELDS]
    records = tile_records(Splats2D(**sp), ntx, nty,
                           RasterConfig(dup_capacity=CAP)).records
    got = torch.autograd.grad(records, leaves, torch.from_numpy(drec),
                              allow_unused=True)
    for k, g, wnt in zip(FIELDS, got, want):
        g = np.zeros(np.shape(wnt), np.float32) if g is None else g.numpy()
        assert knife_edge(g, np.asarray(wnt)), k


def test_mirror_mask_is_exact_on_adversarial_segments():
    """Adversarial records in segments of 48 over a 4x4-tile view, the exit
    state of kernel A's mirror: the mirror with the mask and per-warp
    starts equals the mirror without them bit for bit (NaN where NaN)."""
    rng = np.random.default_rng(1)
    rec = adversarial_records(rng, 128)
    rng.shuffle(rec)
    ntx = nty = 4
    seg = len(rec) // (ntx * nty)
    starts = np.arange(ntx * nty, dtype=np.int32) * seg
    counts = np.full(ntx * nty, seg, np.int32)
    for t in range(ntx * nty):    # each segment around its own tile
        rec[starts[t]:starts[t] + seg, 0] += (t % ntx) * 16
        rec[starts[t]:starts[t] + seg, 1] += (t // ntx) * 16
    with np.errstate(invalid="ignore", over="ignore"):
        state = _kernel_a(rec, starts, counts, ntx, nty)[0][:, 5:]
        gt = rng.normal(0, 1, (ntx * nty, 5, PIX)).astype(np.float32)
        got = _kernel_c(rec, starts, counts, ntx, nty, gt, state)
        ref = _kernel_c(rec, starts, counts, ntx, nty, gt, state,
                        masked=False)
    assert np.array_equal(got, ref, equal_nan=True)
    assert (state[:, 1] < seg).sum() > 0       # some pixels exit
    assert np.isfinite(got).any()


@pytest.mark.parametrize("depth_grad", [True, False])
def test_bwd_guard_takes_plain_on_cpu(depth_grad):
    """On CPU tensors kernel C's wrapper and its guard's both take the
    plain version and launch nothing."""
    tr, ntx, nty, h, w, sp, tiles, gt = _inputs("random")
    args = (tr.records, tr.starts, tr.counts, ntx, nty, torch.from_numpy(gt),
            tiles[:, 5:], depth_grad)
    before = (composite_tiles_bwd.launches,
              composite_tiles_bwd_unmasked.launches)
    want = composite_tiles_bwd_plain(*args[:6], depth_grad)
    assert torch.equal(composite_tiles_bwd_unmasked(*args), want)
    assert torch.equal(composite_tiles_bwd(*args), want)
    assert (composite_tiles_bwd.launches,
            composite_tiles_bwd_unmasked.launches) == before
