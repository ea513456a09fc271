"""Kernel D's design (csrc/composite_bucket_bwd.cu) on the CPU.

Kernel D runs only on the card. Here its algorithm is mirrored in float32
numpy: every tile walks its bucket's segment with kernel C's walk
(``_tile_sums`` of tests/test_torch_bwd_patch.py: kernel A's 8x4 patches,
the patch mask with the rect gate folded in, so a record outside the
tile's rect has mask 0, per-warp starts, the reverse walk from kernel A's
exit state, C's per-warp butterfly and the fixed-order sum of the 8
warps), then each record's sums over its bucket's member tiles are added
in slot order, a member that wrote nothing skipped. Cases, at buckets 2
and 4: a random scene, a dense one (segments of more than 256 records,
pixels that exit) and a 144-pixel-wide view (ntx = 9: the last bucket
column has missing member tiles).

- With the mask and per-warp starts and without them (every warp walks
  every record inside the rect gate below the block's largest exit) the
  mirror is bitwise equal: a pair whose bit is clear, or past its pixel's
  exit, contributes nothing.
- The mirror equals ``composite_tiles_bucket_bwd_plain`` at the knife-edge
  bound of the parity tests per field, relative to max |plain| (mean |Δ| <
  2e-4·scale, at most 1 % above 1e-3·scale), with and without depth_grad,
  and, on the random scene, JAX's Pallas bucket VJP in interpret mode per
  splat field at the same bound (the mirror's record cotangents reach the
  splats through the port's record gather).

    python -m pytest tests/test_torch_bucket_bwd_patch.py -q
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu.ops.rasterize_pallas import rasterize_pallas as j_rasterize_pallas
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu_torch.models.cameras import camera_from_arrays
from gslm_tpu_torch.ops.projection import Splats2D, preprocess
from gslm_tpu_torch.ops.rasterize_cuda import (
    PIX, bucket_of_tile, composite_tiles_bucket_bwd,
    composite_tiles_bucket_bwd_plain, composite_tiles_bucket_bwd_unmasked,
    composite_tiles_plain, tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.utils.synthetic import make_camera, random_gaussians
# pytest puts tests/ on sys.path (see tests/test_torch_bwd_patch.py)
from test_torch_bwd_patch import FIELDS, _tile_sums, knife_edge, to_jax
from test_torch_fwd_patch import BG, CAP
from torch_threads import one_thread  # noqa: F401 (autouse)


def _kernel_d(rec, rects, bstarts, bcounts, ntx, nty, view_rows, bk,
              gtiles, state, depth_grad=True, masked=True, steps=None):
    """Kernel D in float32 numpy → drec (L, 10): ``_tile_sums`` of every
    tile over its bucket's segment under the rect gate, then each row's
    sums over the bucket's member tiles in slot order (member slot s =
    dy * bk + dx), from zero, the members that wrote nothing skipped."""
    bid = bucket_of_tile(ntx, nty, view_rows, bk, "cpu").numpy()
    starts, counts = bstarts[bid], bcounts[bid]
    sums, wrote, n_eff = _tile_sums(rec, starts, counts, ntx, view_rows,
                                    gtiles, state, depth_grad, masked, steps,
                                    rects)
    t = np.arange(ntx * nty)
    slot = ((t // ntx) % view_rows % bk) * bk + t % ntx % bk
    drec = np.zeros_like(rec, dtype=np.float32)
    for s in range(bk * bk):   # one member per bucket: disjoint rows
        for i in range(int(n_eff.max(initial=0))):
            live = (slot == s) & (i < n_eff) & wrote[:, i]
            rows = starts[live] + i
            drec[rows] = drec[rows] + sums[live, i]
    return drec


def bucket_case(name, bk):
    """(TileRecords at bucket ``bk``, ntx, nty, h, w, the port's splat
    fields as a dict): "random" (300 Gaussians, 64x96), "dense" (400,
    spread 0.4, larger: segments of more than 256 records, pixels that
    exit) and "ragged" (the random scene at 64x144: ntx = 9)."""
    n, spread, scales = 300, 1.0, (-3.5, -2.0)
    if name == "dense":
        n, spread, scales = 400, 0.4, (-3.0, -1.5)
    h, w = 64, 144 if name == "ragged" else 96
    params = random_gaussians(np.random.default_rng(0), n=n, spread=spread,
                              scale_range=scales, device="cpu")
    meta = make_camera(height=h, width=w, radius=4.0)
    cam = camera_from_arrays(meta.R, meta.T, meta.fovx, meta.fovy, w, h,
                             device="cpu")
    with torch.no_grad():
        sp = preprocess(params, cam, active_sh_degree=3)
    sp = {k: v.detach().clone() for k, v in vars(sp).items()}
    ntx, nty = -(-w // 16), -(-h // 16)
    tr = tile_records(Splats2D(**sp), ntx, nty,
                      RasterConfig(dup_capacity=CAP, bucket=bk))
    return tr, ntx, nty, h, w, sp


def _state(tr, ntx, nty):
    """The plain forward's exit state (ntiles, 2, 256) of bucket records."""
    tiles, _ = composite_tiles_plain(tr.records, tr.starts, tr.counts, ntx,
                                     nty, tr.buckets.rects)
    return tiles[:, 5:].numpy()


def _mirror(tr, ntx, nty, gt, state, depth_grad=True, masked=True,
            steps=None):
    bk = tr.buckets
    return _kernel_d(tr.records.numpy(), bk.rects.numpy(),
                     bk.bstarts.numpy(), bk.bcounts.numpy(), ntx, nty, nty,
                     bk.bucket, gt, state, depth_grad, masked, steps)


@pytest.mark.parametrize("bucket", [2, 4])
@pytest.mark.parametrize("name", ["random", "dense", "ragged"])
def test_mirror_mask_is_exact_and_matches_plain(name, bucket):
    tr, ntx, nty, h, w, _ = bucket_case(name, bucket)
    state = _state(tr, ntx, nty)
    if name == "dense":   # deep segments, and pixels that exit
        assert int(tr.buckets.bcounts.max()) > PIX
        assert (state[:, 1] < tr.counts.numpy()[:, None]).sum() > 100
    if name == "ragged":  # the last bucket column misses member tiles
        assert ntx % bucket
    gt = np.random.default_rng(2).normal(
        0, 1, (ntx * nty, 5, PIX)).astype(np.float32)
    for depth_grad in (True, False):
        steps = []
        got = _mirror(tr, ntx, nty, gt, state, depth_grad, steps=steps)
        ref = _mirror(tr, ntx, nty, gt, state, depth_grad, masked=False,
                      steps=steps)
        assert np.array_equal(got, ref)
        assert 0 < steps[0] < 0.8 * steps[1], steps   # the design skips
        want = composite_tiles_bucket_bwd_plain(
            tr.records, tr.buckets, ntx, nty, torch.from_numpy(gt),
            depth_grad).numpy()
        for f in range(10):
            assert knife_edge(got[:, f], want[:, f]), (name, depth_grad, f)
        if not depth_grad:
            assert not got[:, 9].any()


@pytest.mark.parametrize("bucket", [2, 4])
def test_mirror_matches_pallas_bucket_vjp(bucket):
    """The mirror's record cotangents, through the port's record gather,
    against JAX's Pallas bucket VJP in interpret mode per splat field."""
    tr, ntx, nty, h, w, sp = bucket_case("random", bucket)
    js = to_jax(sp)
    rng = np.random.default_rng(1)
    u = rng.normal(0, 1, (3, h, w)).astype(np.float32)
    ui = rng.normal(0, 1, (1, h, w)).astype(np.float32)

    def j_loss(*fields):
        out = j_rasterize_pallas(
            js.replace(**dict(zip(FIELDS, fields))), h, w, jnp.asarray(BG),
            JRasterConfig(dup_capacity=CAP, bucket=bucket), interpret=True,
            mode="vjp")
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
    drec = _mirror(tr, ntx, nty, gt, _state(tr, ntx, nty))
    leaves = [sp[k].requires_grad_(True) for k in FIELDS]
    records = tile_records(Splats2D(**sp), ntx, nty, RasterConfig(
        dup_capacity=CAP, bucket=bucket)).records
    got = torch.autograd.grad(records, leaves, torch.from_numpy(drec),
                              allow_unused=True)
    for k, g, wnt in zip(FIELDS, got, want):
        g = np.zeros(np.shape(wnt), np.float32) if g is None else g.numpy()
        assert knife_edge(g, np.asarray(wnt)), k


@pytest.mark.parametrize("depth_grad", [True, False])
def test_bucket_bwd_guard_takes_plain_on_cpu(depth_grad):
    """On CPU tensors kernel D's wrapper and its guard's both take the
    plain version and launch nothing."""
    tr, ntx, nty, h, w, _ = bucket_case("random", 4)
    gt = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (ntx * nty, 5, PIX)).astype(np.float32))
    args = (tr.records, tr.buckets, ntx, nty, gt,
            torch.from_numpy(_state(tr, ntx, nty)), depth_grad)
    before = (composite_tiles_bucket_bwd.launches,
              composite_tiles_bucket_bwd_unmasked.launches)
    want = composite_tiles_bucket_bwd_plain(*args[:5], depth_grad).numpy()
    for fn in (composite_tiles_bucket_bwd_unmasked,
               composite_tiles_bucket_bwd):
        got = fn(*args).numpy()
        for f in range(10):   # the plain version is not bitwise repeatable
            assert knife_edge(got[:, f], want[:, f]), (fn.__name__, f)
    assert (composite_tiles_bucket_bwd.launches,
            composite_tiles_bucket_bwd_unmasked.launches) == before
