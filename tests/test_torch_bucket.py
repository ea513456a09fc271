"""gslm_tpu_torch bucket binning (``RasterConfig.bucket`` > 1): the front
end on the bucket grid, ``overflow_probe``, ``render`` / ``batch_render``,
their gradients (the plain version of kernel D) and J·v against gslm_tpu at
the same bucket, whose Pallas compositors run in interpret mode.

Setting as tests/test_bucket.py: 512 Gaussians, 96x128 and 128x128
cameras, and 128x136 (ntx = 9, so the last bucket column has tiles that do
not exist). Tolerances: the front end and the probe exactly; images and
invdepth 1e-6; gradients 1e-5·max per group (tests/test_bucket.py:85); J·v
1e-6·max (:100-102). The port at bucket 2 equals its own bucket 1 bit for
bit: a tile walks its bucket-1 records, plus records the tile-level cull
drops, whose alpha is below 1/255 on the whole tile, in the same depth
order, and the closed form gates them exactly.

Kernel D runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
Here its numpy mirror (tests/test_torch_bucket_bwd_patch.py: kernel C's
walk per member tile, in reverse from the tile's own exit state under the
rect gate, then each record's sums over the members in slot order) is held
against ``composite_tiles_bucket_bwd_plain`` (autograd of the rect-gated
closed form) on saturated splats where pixels exit."""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.ops import rasterize_tiled as jrt
from gslm_tpu.ops.projection import preprocess as j_preprocess
from gslm_tpu.renderer import batch_render as j_batch_render
from gslm_tpu.renderer import overflow_probe as j_overflow_probe
from gslm_tpu.renderer import render as j_render
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.models import gaussians as G
from gslm_tpu_torch.models.cameras import camera_from_arrays
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops import rasterize_tiled as trt
from gslm_tpu_torch.ops.projection import Splats2D
from gslm_tpu_torch.ops.rasterize_cuda import (
    composite_tiles, composite_tiles_bucket_bwd,
    composite_tiles_bucket_bwd_plain, composite_tiles_bwd,
    composite_tiles_plain, tile_records)
from gslm_tpu_torch.renderer import (batch_render, overflow_probe, render,
                                     stack_views)
from gslm_tpu_torch.utils.synthetic import ring_camera_batch
from tests.test_torch_grad import _bounded, _stack_params, _to_port
# pytest puts tests/ on sys.path (see tests/test_torch_bwd_patch.py)
from test_torch_bucket_bwd_patch import _kernel_d
from torch_threads import one_thread  # noqa: F401 (autouse)

BG = np.zeros(3, np.float32)
CAP = 1 << 14
GRAD_GROUPS = ("xyz", "scaling", "rotation", "opacity", "features_dc",
               "features_rest")


@pytest.fixture(scope="module")
def scene():
    """512 Gaussians in both packages (all alive)."""
    jp, aux = j_random_gaussians(np.random.default_rng(0), n=512,
                                 capacity=512, num_images=2)
    tp = params_from_numpy({g: np.asarray(getattr(jp, g))
                            for g in PARAM_GROUPS}, 3, device="cpu")
    return jp, aux, tp


def _cams(h, w):
    meta = j_make_camera(height=h, width=w)
    return (j_camera_from_meta(meta),
            camera_from_arrays(meta.R, meta.T, meta.fovx, meta.fovy, w, h,
                               device="cpu"))


def _jcfg(bucket, **kw):
    return jrt.RasterConfig(dup_capacity=CAP, impl="pallas", bucket=bucket,
                            **kw)


def _tcfg(bucket, **kw):
    return trt.RasterConfig(dup_capacity=CAP, bucket=bucket, **kw)


def _j_bucket_splats(sp, bk):
    """rasterize_pallas.py:1146-1155, the JAX side's bucket rects."""
    bx0, by0 = sp.rect_min[:, 0] // bk, sp.rect_min[:, 1] // bk
    bx1, by1 = -(-sp.rect_max[:, 0] // bk), -(-sp.rect_max[:, 1] // bk)
    return sp.replace(rect_min=jnp.stack([bx0, by0], axis=-1),
                      rect_max=jnp.stack([bx1, by1], axis=-1),
                      tile_count=jnp.where(sp.tile_count > 0,
                                           (bx1 - bx0) * (by1 - by0), 0))


@pytest.mark.parametrize("bucket", [2, 4])
@pytest.mark.parametrize("views", [1, 2])
def test_bucket_front_end_matches_jax(scene, bucket, views):
    """``_cell_masks`` and ``duplicate_sort_ranges`` at tile_px = 16·bucket
    on the bucket grid of one view or a 2-view stack: every output equal."""
    jp, _, tp = scene
    h, w = 128, 128
    js = [j_preprocess(jp, j_camera_from_meta(j_make_camera(
        height=h, width=w, angle=2 * np.pi * v / views, exposure_idx=v)),
        active_sh_degree=3) for v in range(views)]
    nty = h // 16
    cat = {k: jnp.concatenate([getattr(s, k) for s in js])
           for k in vars(js[0])}
    voff = jnp.repeat(jnp.arange(views, dtype=jnp.int32) * nty, 512)
    cat["rect_min"] = cat["rect_min"].at[:, 1].add(voff)
    cat["rect_max"] = cat["rect_max"].at[:, 1].add(voff)
    jsb = _j_bucket_splats(js[0].replace(**cat), bucket)
    ts = trt.bucket_splats(stack_views(tp, ring_camera_batch(
        views, h, w, device="cpu"))[0], bucket)
    np.testing.assert_array_equal(ts.rect_min.numpy(),
                                  np.asarray(jsb.rect_min))
    np.testing.assert_array_equal(ts.tile_count.numpy(),
                                  np.asarray(jsb.tile_count))
    nbx, vrow_b = -(-(w // 16) // bucket), nty // bucket
    cwb = max(-(-nbx // 8).bit_length(), 1)
    for a, b in zip(jrt._cell_masks(jsb, vrow_b, cwb, tile_px=16 * bucket),
                    trt._cell_masks(ts, vrow_b, cwb, 16 * bucket)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jo = jrt.duplicate_sort_ranges(jsb, nbx, views * vrow_b, CAP,
                                   view_rows=vrow_b, cull=True,
                                   tile_px=16 * bucket)
    to = trt.duplicate_sort_ranges(ts, nbx, views * vrow_b, CAP,
                                   view_rows=vrow_b, cull=True,
                                   tile_px=16 * bucket)
    n = int(to[3][-1])
    assert n > 100
    for k in (0, 2, 3):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1])[:n])
    assert [int(t) for t in to[4]] == [int(t) for t in jo[4]]


@pytest.mark.parametrize("bucket", [2, 4])
def test_bucket_overflow_probe_matches_jax(scene, bucket):
    jp, aux, tp = scene
    jcams = j_ring_camera_batch(2, 128, 128)
    cams = ring_camera_batch(2, 128, 128, device="cpu")
    for cull in (False, True):
        want = j_overflow_probe(jp, jcams, config=_jcfg(bucket, cull=cull),
                                alive=aux.alive, per_view=True)
        got = overflow_probe(tp, cams, config=_tcfg(bucket, cull=cull),
                             per_view=True)
        for k in ("n_aabb", "n_live"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the summed counts against a starved live capacity (cull on)
    tot = overflow_probe(tp, cams, config=_tcfg(bucket, live_capacity=64))
    assert int(tot["n_live"]) == int(np.asarray(want["n_live"]).sum()) > 64
    assert int(tot["overflow"]) == 1


@pytest.mark.parametrize("bucket", [2, 4])
def test_bucket_render_matches_jax(scene, bucket):
    jp, aux, tp = scene
    jcam, cam = _cams(128, 128)
    want = j_render(jp, jcam, jnp.asarray(BG), config=_jcfg(bucket),
                    alive=aux.alive)
    with torch.no_grad():
        got = render(tp, cam, torch.tensor(BG), config=_tcfg(bucket))
        base = render(tp, cam, torch.tensor(BG), config=_tcfg(1))
    for k in ("render", "invdepth"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-6,
                                   err_msg=k)
        # the port's bucket render is its bucket-1 render, bit for bit
        assert torch.equal(getattr(got, k), getattr(base, k)), k
    for k in ("n_duplicates", "overflow", "max_tile_load"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert int(got.n_duplicates) < int(base.n_duplicates)


@pytest.mark.parametrize("bucket,hw", [(2, (128, 136)), (4, (128, 136))])
def test_bucket_grads_match_jax(scene, bucket, hw):
    """Gradients of every group through the plain version of kernel D
    against JAX's Pallas bucket backward; ntx = 9 leaves tiles of the last
    bucket column that do not exist."""
    jp, aux, tp = scene
    h, w = hw
    jcam, cam = _cams(h, w)
    gt = np.random.default_rng(1).uniform(0, 1, (3, h, w)).astype(np.float32)

    def j_loss(p):
        out = j_render(p, jcam, jnp.asarray(BG), config=_jcfg(bucket),
                       alive=aux.alive)
        return (jnp.sum((out.render - gt) ** 2)
                + 0.1 * jnp.sum(out.invdepth))

    want = jax.grad(j_loss)(jp)
    before = composite_tiles.launches, composite_tiles_bucket_bwd.launches
    out = render(tp, cam, torch.tensor(BG), config=_tcfg(bucket))
    loss = (((out.render - torch.tensor(gt)) ** 2).sum()
            + 0.1 * out.invdepth.sum())
    got = torch.autograd.grad(loss, [getattr(tp, k) for k in GRAD_GROUPS])
    # CPU tensors take the plain versions: no kernel was launched
    assert (composite_tiles.launches,
            composite_tiles_bucket_bwd.launches) == before
    for k, g in zip(GRAD_GROUPS, got):
        a = np.asarray(getattr(want, k))
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(g.numpy(), a, atol=1e-5 * scale,
                                   err_msg=k)


def test_bucket_jvp_matches_jax(scene):
    jp, aux, tp = scene
    jcam, cam = _cams(96, 128)
    rng = np.random.default_rng(2)
    v = {g: rng.normal(0, 1e-2, tuple(getattr(tp, g).shape)).astype(
        np.float32) for g in PARAM_GROUPS}

    def img(p):
        return j_render(p, jcam, jnp.asarray(BG), config=_jcfg(2),
                        alive=aux.alive, impl="pallas_jvp").render

    _, want = jax.jvp(img, (jp,), (jp.replace(**{
        g: jnp.asarray(x) for g, x in v.items()}),))
    with torch.no_grad(), fwAD.dual_level():
        duals = {g: fwAD.make_dual(x, torch.tensor(v[g]))
                 for g, x in tp.groups().items()}
        out = render(G.with_groups(tp, duals), cam, torch.tensor(BG),
                     config=_tcfg(2))
        got = fwAD.unpack_dual(out.render).tangent.numpy()
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-6 * scale)


def test_bucket_batched_views_match_jax(scene):
    jp, aux, tp = scene
    want = j_batch_render(jp, j_ring_camera_batch(2, 96, 128),
                          jnp.asarray(BG), config=_jcfg(2), alive=aux.alive)
    cams = ring_camera_batch(2, 96, 128, device="cpu")
    with torch.no_grad():
        got = batch_render(tp, cams, torch.tensor(BG), config=_tcfg(2))
        one = render(tp, cams.view(1), torch.tensor(BG), config=_tcfg(2))
    np.testing.assert_allclose(got.render.numpy(), np.asarray(want.render),
                               atol=1e-6)
    assert int(got.n_duplicates) == int(want.n_duplicates)
    assert torch.equal(one.render, got.render[1])


@pytest.mark.parametrize("bucket", [2, 4])
def test_bucket_reverse_walk_matches_plain_backward(bucket):
    """Kernel D's algorithm (``_kernel_d``: kernel C's walk per member
    tile under the rect gate, then the slot-order sum over the members)
    against autograd of the rect-gated closed form, on a stack of saturated
    splats (pixels exit at T < 1e-4) seen by a 64x80 camera: ntx = 5, so
    buckets of the last column have missing member tiles. Both bounded at
    atol 1e-5·max per field."""
    h, w = 64, 80
    js = j_preprocess(_stack_params(), j_camera_from_meta(j_make_camera(
        height=h, width=w, radius=5.0)), active_sh_degree=3)
    ntx, nty = 5, 4
    tr = tile_records(Splats2D(**_to_port(js)), ntx, nty,
                      trt.RasterConfig(dup_capacity=1 << 12, bucket=bucket))
    bk = tr.buckets
    tiles, _ = composite_tiles_plain(tr.records, tr.starts, tr.counts, ntx,
                                     nty, bk.rects)
    assert int((tiles[:, 6] < tr.counts[:, None]).sum()) > 100
    gt = torch.tensor(np.random.default_rng(2).normal(
        0, 1, (ntx * nty, 5, 256)).astype(np.float32))
    for depth_grad in (True, False):
        want = composite_tiles_bucket_bwd_plain(tr.records, bk, ntx, nty, gt,
                                                depth_grad).numpy()
        got = _kernel_d(
            tr.records.numpy(), bk.rects.numpy(), bk.bstarts.numpy(),
            bk.bcounts.numpy(), ntx, nty, nty, bucket, gt.numpy(),
            tiles[:, 5:].numpy(), depth_grad)
        for f in range(10):
            assert _bounded(got[:, f], want[:, f], "stack"), (
                f, np.abs(got[:, f] - want[:, f]).max())
        # the CPU wrapper is the plain version, state or no state
        before = composite_tiles_bwd.launches
        np.testing.assert_array_equal(composite_tiles_bucket_bwd(
            tr.records, bk, ntx, nty, gt, tiles[:, 5:], depth_grad).numpy(),
            want)
        assert composite_tiles_bwd.launches == before


def test_bucket_config_rejects_other_sizes():
    """bucket must be 1, 2 or 4, as in gslm_tpu."""
    with pytest.raises(ValueError, match="bucket=3"):
        trt.RasterConfig(bucket=3)


def test_bucket_rejects_indivisible_view_rows(scene):
    """The view's tile rows must divide by the bucket."""
    _, _, tp = scene
    _, cam = _cams(96, 128)   # 6 tile rows
    with pytest.raises(ValueError, match="divisible"):
        render(tp, cam, torch.tensor(BG), config=_tcfg(4))
    with pytest.raises(ValueError, match="divisible"):
        overflow_probe(tp, ring_camera_batch(1, 96, 128, device="cpu"),
                       config=_tcfg(4))
