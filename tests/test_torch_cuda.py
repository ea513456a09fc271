"""gslm_tpu_torch kernels on the card, each against its plain PyTorch
version. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Without a card every test skips (CUDA kernels have no CPU mode).
Tolerances: kernel A at the random-scene bounds of the parity tests
(mean |Δ| < 2e-4, at most 1% of values above 1e-3: knife edges at the 1/255
gate); kernel C at the same bounds per record field, relative to the
field's max |plain| (its 1e-4 and 1/255 gates can flip against the plain
closed form), and bit for bit against itself; kernel B, forward, VJP and
JVP, bit for bit (same tap order, no FMA contraction). Kernel E on a dense
scene where pixels exit: its primal against kernel A's (the same pair
arithmetic: 1e-6, bit for bit expected), its tangent at the knife-edge
bound per row relative to max |plain|, and bit for bit against itself;
one LM outer step through kernels A, C and E: the launch counts and finite
results. Bucket mode (buckets of 2 and 4 tiles on a 13-column grid, so the
last bucket column has missing member tiles): kernels A and E with the rect
gate against their plain versions at the bounds above, kernel A's bucket
composite equal to its bucket-1 composite, kernel D against its plain
version per record field (kernel C's bound) and bit for bit against
itself. Kernel A's and the masked kernel E's 8x4 patches and patch mask
against the guard E<MASK=false>, which walks every record through
pair_alpha (bit for bit, primal rows 0-6; the masked E's tangent within
1e-6 of max |guard| per row): segments of 1,200 records in one tile
(several chunks, blocks that stop at a chunk boundary), partial tiles,
buckets of 4 at ntx = 5, 9 and 13, and the adversarial records of
tests/patch_cases.py. Kernel C on 8x4 patches with the mask, per-warp
starts and its reduce-scatter sum: against its plain version per field
and bit for bit against itself, with and without depth_grad, on the small
scene and on the 1,200-record segments (19 chunks of 64, pixels that exit
in the first); and bit for bit against its guard C<MASK=false> (every
patch bit set) on those and on the adversarial records, which holds the
patch bits kernel C computes to the pairs that contribute. Kernel D (C's
walk per member tile, a slot-order sum per record) likewise bit for bit
against its guard D<MASK=false> and itself at buckets 2 and 4, with and
without depth_grad, on the small scene's bucket records and on the
1,200-record and adversarial segments regrouped into buckets with seeded
rects; against its plain version on ragged views (ntx = 5, 9). Kernel B
equal to ``blur_plain`` (``torch.equal``) for k in {1, 3, 5, 11, 15} on
(15, 67, 133), (1, 5, 3) and (2, 1080, 1920): forward, the
reversed-tap VJP and the JVP. ``densify_and_prune`` on the card equal to
its run on CPU copies of the same inputs and noise: the counts and
``alive`` exactly, parameters within 1e-6 of max |value| per group (CUDA's
and the CPU's float32 exp and sigmoid may differ in the last bit). Kernel
C at depth_grad=True on a depth L1's cotangent (invdepth row nonzero)
against its plain version at the bound above; LPIPS on the card within
1e-4 relative of the CPU's, TF32 on in the caller; the quick parity matrix
(utils/paritycheck.py) all ok. A one-rank NCCL group: the data-parallel
Adam step (parallel/steps.py) equal to ``train_step`` bit for bit. Kernel
F (the 3-NN grid search) equal to its plain version with ``torch.equal``
and to itself on tests/knn_cases.py's clouds (points on cell faces,
coplanar, collinear, identical, duplicates, P from 1 to 5, far outliers)
and on 100,000 uniform and clustered points; ``create_from_pcd`` launches
it once. Kernel G (the cull masks) equal to ``_cell_masks_plain`` on the
card bit for bit, all five outputs: the small scene at tile_px 16, 32 and
64, two stacked views, seeded splats at the masks' edges (rects over 8
units, opacity under 1/255 and at the 1e-12 clamp, b² near a·c, a and c at
the clamp, tile_count 0), fields that are strided views of packed rows,
forward-AD duals, a 1,048,576-Gaussian 1080p
view; ``duplicate_sort_ranges`` with it equal to its run on the plain
masks, one launch a call. Kernel H (the preprocess, no grad) equal to
``preprocess_plain`` bit for bit on every field of ``Splats2D``: three
1237x822 views of the full-size ``mip360-3m`` scene law (two on the
training ring, one off it), SH degrees 0-4 with and without
antialiasing, ``scaling_modifier`` 0.5 and 1.7, tests/preprocess_cases.py's
edge rows, ``alive``, ``color_override`` and ``mean2d_offset``, P = 0 (no
launch); a float64 group, a CPU camera, a float mask and a missing SH
degree raise; grad mode with leaves that require grad and forward-AD
duals run the plain graph (no launch, the plain calls counted); one launch
per ``render`` and ``batch_render`` view, none in ``train_step``."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from gslm_tpu_torch.config import LMParams, OptimizationParams
from gslm_tpu_torch.densify import densify_and_prune
from gslm_tpu_torch.models.cameras import Camera
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                             GaussianParams,
                                             params_from_numpy, with_groups)
from gslm_tpu_torch.ops.blur_cuda import blur, blur_plain, blur_same
from gslm_tpu_torch.ops import projection, rasterize_tiled
from gslm_tpu_torch.ops.projection import (Splats2D, preprocess,
                                           preprocess_cuda, preprocess_plain)
from gslm_tpu_torch.ops.rasterize_cuda import (
    BucketSegments, bucket_of_tile, composite_tiles,
    composite_tiles_bucket_bwd, composite_tiles_bucket_bwd_plain,
    composite_tiles_bucket_bwd_unmasked, composite_tiles_bwd,
    composite_tiles_bwd_plain, composite_tiles_bwd_unmasked,
    composite_tiles_jvp, composite_tiles_jvp_plain,
    composite_tiles_jvp_unmasked, composite_tiles_plain, tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.ops.ssim import gaussian_taps
from gslm_tpu_torch.optim import AdamState, init_adam
from gslm_tpu_torch.renderer import batch_render, render, stack_views
from gslm_tpu_torch.train import loss_and_grads, train_step
from gslm_tpu_torch.train_lm import lm_outer_step
from gslm_tpu_torch.utils.synthetic import (clustered_cloud, random_gaussians,
                                            ring_camera_batch)
from knn_cases import hard_clouds
# pytest puts tests/ on sys.path; an installed ``tests`` package can shadow
# the name ``tests.patch_cases``
from patch_cases import adversarial_records
from preprocess_cases import edge_groups, look_at


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _small_scene(cuda):
    params = random_gaussians(np.random.default_rng(0), n=4096, spread=1.5,
                              device=cuda)
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    with torch.no_grad():
        splats = preprocess(params, cam, active_sh_degree=3)
        return tile_records(splats, 13, 8, RasterConfig())[:3]


def _knife_edge(got, want, scale=1.0):
    d = (got - want).abs()
    return (float(d.mean()) < 2e-4 * scale
            and float((d > 1e-3 * scale).float().mean()) <= 0.01)


@pytest.mark.cuda
def test_composite_kernel_matches_plain(cuda):
    records, starts, counts = _small_scene(cuda)
    before = composite_tiles.launches
    got, walked = composite_tiles(records, starts, counts, 13, 8)
    want, _ = composite_tiles_plain(records, starts, counts, 13, 8)
    torch.cuda.synchronize()
    assert composite_tiles.launches == before + 1
    assert _knife_edge(got[:, :5], want[:, :5])
    # exit state: positions agree but for knife edges at T = 1e-4
    assert float((got[:, 6] != want[:, 6]).float().mean()) <= 0.01
    assert bool((walked <= counts).all())


def _bwd_inputs(cuda):
    records, starts, counts = _small_scene(cuda)
    tiles, _ = composite_tiles(records, starts, counts, 13, 8)
    gtiles = torch.randn(counts.shape[0], 5, 256, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    return records, starts, counts, gtiles, tiles[:, 5:]


@pytest.mark.cuda
@pytest.mark.parametrize("depth_grad", [True, False])
def test_composite_bwd_kernel_matches_plain(cuda, depth_grad):
    records, starts, counts, gtiles, state = _bwd_inputs(cuda)
    before = composite_tiles_bwd.launches
    got = composite_tiles_bwd(records, starts, counts, 13, 8, gtiles, state,
                              depth_grad)
    want = composite_tiles_bwd_plain(records, starts, counts, 13, 8, gtiles,
                                     depth_grad)
    torch.cuda.synchronize()
    assert composite_tiles_bwd.launches == before + 1
    assert bool(torch.isfinite(got).all())
    for f in range(10):
        scale = float(want[:, f].abs().max()) + 1e-12
        assert _knife_edge(got[:, f], want[:, f], scale), f
    if not depth_grad:
        assert float(got[:, 9].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("depth_grad", [True, False])
def test_composite_bwd_kernel_is_deterministic(cuda, depth_grad):
    args = _bwd_inputs(cuda)
    a = composite_tiles_bwd(*args[:3], 13, 8, *args[3:], depth_grad)
    b = composite_tiles_bwd(*args[:3], 13, 8, *args[3:], depth_grad)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_blur_kernel_matches_plain(cuda):
    x = torch.rand(15, 67, 133, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(0))
    before = blur_same.launches
    got = blur_same(x, gaussian_taps())
    want = blur_plain(x, gaussian_taps())
    torch.cuda.synchronize()
    assert blur_same.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 67, 133), (1, 5, 3), (2, 1080, 1920)])
@pytest.mark.parametrize("k", [1, 3, 5, 11, 15])
def test_blur_kernel_equals_plain(cuda, k, shape):
    """Kernel B equal to ``blur_plain`` bit for bit for every tap count the
    SSIM path could use, on a ragged shape, a plane smaller than the halo
    and a 1080p pair of planes: forward, the VJP (reversed asymmetric taps)
    and the JVP (the same taps)."""
    rng = np.random.default_rng(k)
    taps = rng.uniform(0.05, 1.0, k).astype(np.float32)
    gen = torch.Generator(cuda).manual_seed(k)
    x = torch.rand(shape, device=cuda, generator=gen, requires_grad=True)
    g = torch.randn(shape, device=cuda, generator=gen)
    before = blur_same.launches, blur_same.vjp_launches, blur_same.jvp_launches
    out = blur(x, taps)
    (gx,) = torch.autograd.grad(out, x, g)
    with fwAD.dual_level():
        _, tangent = fwAD.unpack_dual(blur(fwAD.make_dual(x.detach(), g),
                                           taps))
    torch.cuda.synchronize()
    assert (blur_same.launches - before[0], blur_same.vjp_launches
            - before[1], blur_same.jvp_launches - before[2]) == (4, 1, 1)
    assert torch.equal(out, blur_plain(x.detach(), taps))
    assert torch.equal(gx, blur_plain(g, taps[::-1]))
    assert torch.equal(tangent, blur_plain(g, taps))


@pytest.mark.cuda
def test_blur_vjp_matches_reversed_tap_plain(cuda):
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.rand(2, 15, 67, 133, device=cuda, generator=gen,
                   requires_grad=True)
    g = torch.randn(2, 15, 67, 133, device=cuda, generator=gen)
    taps = np.array([0.1, 0.5, 0.2, 0.15, 0.05], np.float32)
    before = blur_same.launches, blur_same.vjp_launches
    (got,) = torch.autograd.grad(blur(x, taps), x, g)
    torch.cuda.synchronize()
    assert (blur_same.launches, blur_same.vjp_launches) == (
        before[0] + 2, before[1] + 1)
    assert float((got - blur_plain(g, taps[::-1])).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_train_step_on_card(cuda):
    """One Adam step through kernels A, C and B (twice): every gradient,
    parameter and statistic finite."""
    params = random_gaussians(np.random.default_rng(3), n=2048, spread=1.5,
                              device=cuda)
    cams = ring_camera_batch(1, 72, 96, device=cuda)
    counts = (composite_tiles.launches, blur_same.launches,
              composite_tiles_bwd.launches)
    kw = dict(rcfg=RasterConfig(), opt=OptimizationParams(),
              active_sh_degree=3, use_exp=False)
    _, _, _, grads, g_m2d = loss_and_grads(params, cams,
                                           torch.zeros(3, device=cuda), 0.0,
                                           **kw)
    assert all(bool(torch.isfinite(grads[g]).all()) for g in PARAM_GROUPS)
    assert bool(torch.isfinite(g_m2d).all()) and float(g_m2d.abs().max()) > 0
    params, aux, _, metrics = train_step(
        params, GaussianAux.zeros(2048, device=cuda), init_adam(params),
        cams, torch.zeros(3, device=cuda), 100, 1.0, 0.0,
        sparse_adam=False, update_stats=True, **kw)
    torch.cuda.synchronize()
    assert (composite_tiles.launches - counts[0],
            blur_same.launches - counts[1],
            composite_tiles_bwd.launches - counts[2]) == (2, 4, 2)
    assert all(bool(torch.isfinite(getattr(params, g)).all())
               for g in PARAM_GROUPS)
    assert all(bool(torch.isfinite(getattr(aux, f)).all())
               for f in ("max_radii2d", "xyz_gradient_accum", "denom"))
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.cuda
def test_batched_view_equals_single_view(cuda):
    params = random_gaussians(np.random.default_rng(1), n=2048, device=cuda)
    cams = ring_camera_batch(3, 72, 96, device=cuda)
    bg = torch.tensor([0.2, 0.5, 0.8], device=cuda)
    out = batch_render(params, cams, bg, use_trained_exp=True)
    for v in range(3):
        one = render(params, cams.view(v), bg, use_trained_exp=True)
        assert torch.equal(one.render, out.render[v])
        assert torch.equal(one.invdepth, out.invdepth[v])


def _jvp_inputs(cuda):
    """A dense scene (7,830 of 26,624 pixels exit) and a seeded tangent."""
    params = random_gaussians(np.random.default_rng(5), n=2048, spread=0.8,
                              scale_range=(-2.5, -1.5), device=cuda)
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    with torch.no_grad():
        splats = preprocess(params, cam, active_sh_degree=3)
        records, starts, counts, *_ = tile_records(splats, 13, 8,
                                                  RasterConfig())
    tangents = torch.randn(records.shape, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(4))
    return records, tangents, starts, counts


@pytest.mark.cuda
def test_composite_jvp_kernel_matches_plain(cuda):
    records, tangents, starts, counts = _jvp_inputs(cuda)
    before = composite_tiles_jvp.launches
    tiles, tiles_dot = composite_tiles_jvp(records, tangents, starts, counts,
                                           13, 8)
    fwd, _ = composite_tiles(records, starts, counts, 13, 8)
    want, want_dot = composite_tiles_jvp_plain(records, tangents, starts,
                                               counts, 13, 8)
    torch.cuda.synchronize()
    assert composite_tiles_jvp.launches == before + 1
    assert int((fwd[:, 6] < counts[:, None]).sum()) > 1000   # exits taken
    assert float((tiles - fwd).abs().max()) <= 1e-6
    assert bool(torch.isfinite(tiles_dot).all())
    for row in range(5):
        scale = float(want_dot[:, row].abs().max()) + 1e-12
        assert _knife_edge(tiles_dot[:, row], want_dot[:, row], scale), row
    assert _knife_edge(tiles[:, :5], want[:, :5])


@pytest.mark.cuda
def test_composite_jvp_kernel_is_deterministic(cuda):
    args = _jvp_inputs(cuda)
    a = composite_tiles_jvp(*args, 13, 8)
    b = composite_tiles_jvp(*args, 13, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_blur_jvp_matches_plain(cuda):
    gen = torch.Generator(cuda).manual_seed(5)
    x = torch.rand(2, 15, 67, 133, device=cuda, generator=gen)
    v = torch.randn(2, 15, 67, 133, device=cuda, generator=gen)
    taps = np.array([0.1, 0.5, 0.2, 0.15, 0.05], np.float32)
    before = blur_same.launches, blur_same.jvp_launches
    with fwAD.dual_level():
        primal, tangent = fwAD.unpack_dual(blur(fwAD.make_dual(x, v), taps))
    torch.cuda.synchronize()
    assert (blur_same.launches, blur_same.jvp_launches) == (
        before[0] + 2, before[1] + 1)
    assert float((primal - blur_plain(x, taps)).abs().max()) <= 1e-6
    assert float((tangent - blur_plain(v, taps)).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_lm_outer_step_on_card(cuda):
    """One LM outer step (2-view window, 4 val views in 2 chunks, default
    CG): A once for the linearization and 7 alphas x 2 chunks, E 6 times,
    C 4 times; xyz unchanged, finite results."""
    params = random_gaussians(np.random.default_rng(3), n=2048, spread=1.5,
                              num_images=6, device=cuda)
    cams = ring_camera_batch(6, 72, 96, device=cuda)
    counts = (composite_tiles.launches, composite_tiles_jvp.launches,
              composite_tiles_bwd.launches)
    new, info = lm_outer_step(
        params, params.alive, cams.take(slice(0, 2)), cams.take(slice(2, 6)),
        torch.zeros(3, device=cuda), rcfg=RasterConfig(),
        lm=LMParams(num_images=2, micro_batch=2, num_val_views=4),
        active_sh_degree=3, use_exp=False)
    torch.cuda.synchronize()
    assert (composite_tiles.launches - counts[0],
            composite_tiles_jvp.launches - counts[1],
            composite_tiles_bwd.launches - counts[2]) == (15, 6, 4)
    assert torch.equal(new.xyz, params.xyz)
    assert all(bool(torch.isfinite(getattr(new, g)).all())
               for g in PARAM_GROUPS)
    assert np.isfinite(float(info["best_val_loss"]))


def _bucket_inputs(cuda, bucket):
    """The small scene's bucket records, kernel A's bucket composite and a
    seeded image cotangent: 13x8 tiles, buckets of ``bucket`` tiles."""
    params = random_gaussians(np.random.default_rng(0), n=4096, spread=1.5,
                              device=cuda)
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    with torch.no_grad():
        splats = preprocess(params, cam, active_sh_degree=3)
        tr = tile_records(splats, 13, 8, RasterConfig(bucket=bucket))
    tiles, walked = composite_tiles(tr.records, tr.starts, tr.counts, 13, 8,
                                    tr.buckets.rects)
    gtiles = torch.randn(13 * 8, 5, 256, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    return tr, tiles, walked, gtiles


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [2, 4])
def test_bucket_composite_kernels_match_plain(cuda, bucket):
    tr, tiles, walked, _ = _bucket_inputs(cuda, bucket)
    rects = tr.buckets.rects
    want, _ = composite_tiles_plain(tr.records, tr.starts, tr.counts, 13, 8,
                                    rects)
    records, starts, counts = _small_scene(cuda)
    base, _ = composite_tiles(records, starts, counts, 13, 8)
    tangents = torch.randn(tr.records.shape, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(4))
    got_e, dot_e = composite_tiles_jvp(tr.records, tangents, tr.starts,
                                       tr.counts, 13, 8, rects)
    want_e, want_dot = composite_tiles_jvp_plain(
        tr.records, tangents, tr.starts, tr.counts, 13, 8, rects)
    torch.cuda.synchronize()
    assert _knife_edge(tiles[:, :5], want[:, :5])
    assert bool((walked <= tr.counts).all())
    # the rect gate leaves each tile its bucket-1 records, in order
    assert torch.equal(tiles[:, :6], base[:, :6])
    assert torch.equal(got_e, tiles)
    for row in range(5):
        scale = float(want_dot[:, row].abs().max()) + 1e-12
        assert _knife_edge(dot_e[:, row], want_dot[:, row], scale), row


@pytest.mark.cuda
@pytest.mark.parametrize("bucket,depth_grad", [(2, True), (4, True),
                                               (4, False)])
def test_bucket_bwd_kernel_matches_plain(cuda, bucket, depth_grad):
    tr, tiles, _, gtiles = _bucket_inputs(cuda, bucket)
    before = composite_tiles_bucket_bwd.launches
    got = composite_tiles_bucket_bwd(tr.records, tr.buckets, 13, 8, gtiles,
                                     tiles[:, 5:], depth_grad)
    again = composite_tiles_bucket_bwd(tr.records, tr.buckets, 13, 8, gtiles,
                                       tiles[:, 5:], depth_grad)
    want = composite_tiles_bucket_bwd_plain(tr.records, tr.buckets, 13, 8,
                                            gtiles, depth_grad)
    torch.cuda.synchronize()
    assert composite_tiles_bucket_bwd.launches == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    for f in range(10):
        scale = float(want[:, f].abs().max()) + 1e-12
        assert _knife_edge(got[:, f], want[:, f], scale), f
    if not depth_grad:
        assert float(got[:, 9].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("width", [80, 144])
def test_bucket_bwd_kernel_on_ragged_views(cuda, width):
    """Kernel D at bucket 4 on views of ntx = 5 and 9 (the last bucket
    column has missing member tiles): against its plain version per field,
    bit for bit against itself and against its guard D<MASK=false>."""
    params = random_gaussians(np.random.default_rng(0), n=4096, spread=1.5,
                              device=cuda)
    cam = ring_camera_batch(1, 128, width, device=cuda).view(0)
    ntx = -(-width // 16)
    with torch.no_grad():
        splats = preprocess(params, cam, active_sh_degree=3)
        tr = tile_records(splats, ntx, 8, RasterConfig(bucket=4))
    tiles, _ = composite_tiles(tr.records, tr.starts, tr.counts, ntx, 8,
                               tr.buckets.rects)
    gtiles = torch.randn(ntx * 8, 5, 256, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    args = (tr.records, tr.buckets, ntx, 8, gtiles, tiles[:, 5:], True)
    got = composite_tiles_bucket_bwd(*args)
    again = composite_tiles_bucket_bwd(*args)
    guard = composite_tiles_bucket_bwd_unmasked(*args)
    want = composite_tiles_bucket_bwd_plain(*args[:5], True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _bits_equal(got, guard)
    for f in range(10):
        scale = float(want[:, f].abs().max()) + 1e-12
        assert _knife_edge(got[:, f], want[:, f], scale), f


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _deep_segments(cuda):
    """3x2 tiles of 1,200 records each around its own tile: tiles 0-2
    opaque (every pixel exits in the first chunk), tiles 3-5 faint (the
    walk goes through all five chunks)."""
    rng = np.random.default_rng(7)
    ntx, nty, n = 3, 2, 1200
    rec = np.zeros((ntx * nty * n, 10), np.float32)
    for t in range(ntx * nty):
        r = rec[t * n:(t + 1) * n]
        opaque = t < 3   # wide, opaque splats centred in the tile
        lo, hi = (0, 16) if opaque else (-8, 24)
        r[:, 0] = (t % ntx) * 16 + rng.uniform(lo, hi, n)
        r[:, 1] = (t // ntx) * 16 + rng.uniform(lo, hi, n)
        k = rng.uniform(0.01, 0.05, n) if opaque else rng.uniform(0.02, 0.5, n)
        r[:, 2], r[:, 4] = k, k * rng.uniform(0.5, 2.0, n)
        r[:, 3] = rng.uniform(-0.5, 0.5, n) * np.sqrt(r[:, 2] * r[:, 4])
        r[:, 5] = (rng.uniform(0.7, 0.99, n) if opaque
                   else rng.uniform(0.005, 0.05, n))
        r[:, 6:] = rng.uniform(0.0, 1.0, (n, 4))
    starts = torch.arange(ntx * nty, dtype=torch.int32, device=cuda) * n
    counts = torch.full((ntx * nty,), n, dtype=torch.int32, device=cuda)
    return torch.tensor(rec, device=cuda), starts, counts, ntx, nty


def _held_to_guard(tiles, records, starts, counts, ntx, nty, rects=None):
    """Kernel A's rows ``tiles`` and the masked kernel E's primal bit for
    bit against the guard E<MASK=false>'s, E's tangent (a seeded one)
    within 1e-6 of max |guard| per row, non-finite where the guard's is."""
    tangents = torch.randn(records.shape, device=records.device,
                           generator=torch.Generator(
                               records.device).manual_seed(8))
    before = composite_tiles_jvp_unmasked.launches
    guard, guard_dot = composite_tiles_jvp_unmasked(
        records, tangents, starts, counts, ntx, nty, rects)
    primal, dot = composite_tiles_jvp(records, tangents, starts, counts, ntx,
                                      nty, rects)
    torch.cuda.synchronize()
    assert composite_tiles_jvp_unmasked.launches == before + 1
    assert _bits_equal(tiles, guard)
    assert _bits_equal(primal, guard)
    for row in range(5):
        fin = torch.isfinite(guard_dot[:, row])
        assert torch.equal(fin, torch.isfinite(dot[:, row])), row
        want, got = guard_dot[:, row][fin], dot[:, row][fin]
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max()), row


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deep", "partial"])
def test_patch_kernel_equals_strip_walk(cuda, case):
    """Kernel A and the masked kernel E against the guard E<MASK=false>
    (``_held_to_guard``), A against its plain version at the knife-edge
    bound."""
    if case == "deep":
        records, starts, counts, ntx, nty = _deep_segments(cuda)
    else:   # 120x200: 7.5 tile rows, 12.5 tile columns
        (records, starts, counts), ntx, nty = _small_scene(cuda), 13, 8
    tiles, walked = composite_tiles(records, starts, counts, ntx, nty)
    want, _ = composite_tiles_plain(records, starts, counts, ntx, nty)
    torch.cuda.synchronize()
    _held_to_guard(tiles, records, starts, counts, ntx, nty)
    assert _knife_edge(tiles[:, :5], want[:, :5])
    assert float((tiles[:, 6] != want[:, 6]).float().mean()) <= 0.01
    w, c = walked.cpu().numpy(), counts.cpu().numpy()
    assert all(k == n or (k % 256 == 0 and k < n) for k, n in zip(w, c))
    if case == "deep":   # stopped after one chunk, and walked all five
        assert list(w) == [256] * 3 + [1200] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("width", [80, 144, 208])
def test_patch_kernel_bucket4_equals_strip_walk(cuda, width):
    """Bucket 4 at ntx = 5, 9 and 13 (bucket columns with missing member
    tiles): kernel A<RECT> and the masked E<RECT> against the guard
    E<RECT, MASK=false> (``_held_to_guard``), A against its plain version
    and against kernel A at bucket 1 (rows 0-5)."""
    params = random_gaussians(np.random.default_rng(0), n=4096, spread=1.5,
                              device=cuda)
    cam = ring_camera_batch(1, 128, width, device=cuda).view(0)
    ntx = -(-width // 16)
    with torch.no_grad():
        splats = preprocess(params, cam, active_sh_degree=3)
        tr = tile_records(splats, ntx, 8, RasterConfig(bucket=4))
        base = tile_records(splats, ntx, 8, RasterConfig())
    rects = tr.buckets.rects
    tiles, _ = composite_tiles(tr.records, tr.starts, tr.counts, ntx, 8,
                               rects)
    want, _ = composite_tiles_plain(tr.records, tr.starts, tr.counts, ntx, 8,
                                    rects)
    one, _ = composite_tiles(base.records, base.starts, base.counts, ntx, 8)
    torch.cuda.synchronize()
    _held_to_guard(tiles, tr.records, tr.starts, tr.counts, ntx, 8, rects)
    assert _knife_edge(tiles[:, :5], want[:, :5])
    assert torch.equal(tiles[:, :6], one[:, :6])


def _adversarial_segments(cuda):
    """The adversarial records of the CPU property test (threshold
    opacities, ellipse edges on patch borders, strong anisotropy, conics
    that are not positive definite, NaN and inf fields), in segments of 48
    around each of 4x4 tiles."""
    rng = np.random.default_rng(1)
    rec = adversarial_records(rng, 128)
    rng.shuffle(rec)
    ntx = nty = 4
    seg = len(rec) // (ntx * nty)
    for t in range(ntx * nty):
        rec[t * seg:(t + 1) * seg, 0] += (t % ntx) * 16
        rec[t * seg:(t + 1) * seg, 1] += (t // ntx) * 16
    records = torch.tensor(rec, device=cuda)
    starts = torch.arange(ntx * nty, dtype=torch.int32, device=cuda) * seg
    counts = torch.full((ntx * nty,), seg, dtype=torch.int32, device=cuda)
    return records, starts, counts, ntx, nty


@pytest.mark.cuda
def test_patch_kernel_on_adversarial_records(cuda):
    """``_adversarial_segments``: kernel A and the masked kernel E held to
    the guard E<MASK=false> (``_held_to_guard``)."""
    records, starts, counts, ntx, nty = _adversarial_segments(cuda)
    tiles, walked = composite_tiles(records, starts, counts, ntx, nty)
    torch.cuda.synchronize()
    _held_to_guard(tiles, records, starts, counts, ntx, nty)
    assert bool((walked == counts).all())
    assert int((tiles[:, 6] < counts[:, None]).sum()) > 0  # some pixels exit


@pytest.mark.cuda
@pytest.mark.parametrize("depth_grad", [True, False])
@pytest.mark.parametrize("case", ["small", "deep", "adversarial"])
def test_composite_bwd_kernel_equals_guard(cuda, case, depth_grad):
    """Kernel C bit for bit against its guard C<MASK=false> (every patch
    bit set): skipping a pair whose bit kernel C clears must change no bit
    of drec, so a bit cleared for a pair that contributes shows. On the
    small scene, the 1,200-record segments and the adversarial records."""
    if case == "small":
        (records, starts, counts), ntx, nty = _small_scene(cuda), 13, 8
    elif case == "deep":
        records, starts, counts, ntx, nty = _deep_segments(cuda)
    else:
        records, starts, counts, ntx, nty = _adversarial_segments(cuda)
    tiles, _ = composite_tiles(records, starts, counts, ntx, nty)
    gtiles = torch.randn(counts.shape[0], 5, 256, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(10))
    args = (records, starts, counts, ntx, nty, gtiles, tiles[:, 5:],
            depth_grad)
    before = composite_tiles_bwd_unmasked.launches
    guard = composite_tiles_bwd_unmasked(*args)
    got = composite_tiles_bwd(*args)
    torch.cuda.synchronize()
    assert composite_tiles_bwd_unmasked.launches == before + 1
    assert _bits_equal(got, guard)
    if case != "adversarial":
        assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("depth_grad", [True, False])
def test_composite_bwd_kernel_on_deep_segments(cuda, depth_grad):
    """Kernel C on 1,200-record segments (19 chunks of 64; tiles 0-2 exit
    in the first chunk, so their warps start low): against its plain
    version per field and bit for bit against itself; rows past every exit
    exactly zero."""
    records, starts, counts, ntx, nty = _deep_segments(cuda)
    tiles, _ = composite_tiles(records, starts, counts, ntx, nty)
    gtiles = torch.randn(counts.shape[0], 5, 256, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(9))
    args = (records, starts, counts, ntx, nty, gtiles)
    got = composite_tiles_bwd(*args, tiles[:, 5:], depth_grad)
    again = composite_tiles_bwd(*args, tiles[:, 5:], depth_grad)
    want = composite_tiles_bwd_plain(*args, depth_grad)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    for f in range(10):
        scale = float(want[:, f].abs().max()) + 1e-12
        assert _knife_edge(got[:, f], want[:, f], scale), f
    n_eff = tiles[:, 6].amax(dim=1).long()
    for t in range(3):   # opaque tiles: every row past the exits is zero
        assert int(n_eff[t]) < 256
        assert float(got[t * 1200 + int(n_eff[t]):(t + 1) * 1200]
                     .abs().max()) == 0.0


def _as_buckets(records, starts, counts, ntx, nty, bucket, seed):
    """Per-tile segments regrouped as bucket segments on a grid padded to
    whole buckets (the added tiles own no records): bucket b's segment is
    its member tiles' records in slot order, each record given a seeded
    rect of whole tiles inside the bucket (which may miss its own tile).
    Returns (records, BucketSegments, ntx, nty) on the padded grid."""
    dev = records.device
    rng = np.random.default_rng(seed)
    st, cn = starts.cpu().numpy(), counts.cpu().numpy()
    nbx, nby = -(-ntx // bucket), -(-nty // bucket)
    rows, rects, bst, bcn = [], [], [], []
    for b in range(nbx * nby):
        bx, by = b % nbx, b // nbx
        bst.append(sum(len(r) for r in rows))
        for s in range(bucket * bucket):
            tx, ty = bx * bucket + s % bucket, by * bucket + s // bucket
            if tx >= ntx or ty >= nty:
                continue
            idx = np.arange(st[ty * ntx + tx], st[ty * ntx + tx]
                            + cn[ty * ntx + tx])
            rows.append(idx)
            lo = rng.integers(0, bucket, (len(idx), 2))
            hi = lo + 1 + rng.integers(0, bucket, (len(idx), 2))
            q = np.stack([bx * bucket + lo[:, 0], bx * bucket + hi[:, 0],
                          by * bucket + lo[:, 1], by * bucket + hi[:, 1]], 1)
            rects.append(16 * q)
        bcn.append(sum(len(r) for r in rows) - bst[-1])
    idx = torch.as_tensor(np.concatenate(rows), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    buckets = BucketSegments(
        rects=torch.as_tensor(np.concatenate(rects), **i32),
        bstarts=torch.as_tensor(bst, **i32),
        bcounts=torch.as_tensor(bcn, **i32), bucket=bucket)
    return (records[idx].contiguous(), buckets, nbx * bucket,
            nby * bucket)


@pytest.mark.cuda
@pytest.mark.parametrize("depth_grad", [True, False])
@pytest.mark.parametrize("case", ["small", "deep", "adversarial"])
@pytest.mark.parametrize("bucket", [2, 4])
def test_bucket_bwd_kernel_equals_guard(cuda, bucket, case, depth_grad):
    """Kernel D bit for bit against its guard D<MASK=false> (every patch
    bit set inside the rect gate), under rects: the small scene's bucket
    records, and the 1,200-record and adversarial segments regrouped into
    buckets with seeded rects (``_as_buckets``); D bitwise repeatable."""
    if case == "small":
        tr = _bucket_inputs(cuda, bucket)[0]
        records, buckets, ntx, nty = tr.records, tr.buckets, 13, 8
    else:
        segs = (_deep_segments(cuda) if case == "deep"
                else _adversarial_segments(cuda))
        records, buckets, ntx, nty = _as_buckets(*segs, bucket, seed=11)
    bid = bucket_of_tile(ntx, nty, nty, bucket, cuda)
    tiles, _ = composite_tiles(records, buckets.bstarts[bid],
                               buckets.bcounts[bid], ntx, nty, buckets.rects)
    gtiles = torch.randn(ntx * nty, 5, 256, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(12))
    args = (records, buckets, ntx, nty, gtiles, tiles[:, 5:], depth_grad)
    before = (composite_tiles_bucket_bwd.launches,
              composite_tiles_bucket_bwd_unmasked.launches)
    guard = composite_tiles_bucket_bwd_unmasked(*args)
    got = composite_tiles_bucket_bwd(*args)
    again = composite_tiles_bucket_bwd(*args)
    torch.cuda.synchronize()
    assert (composite_tiles_bucket_bwd.launches,
            composite_tiles_bucket_bwd_unmasked.launches) == (before[0] + 2,
                                                              before[1] + 1)
    assert _bits_equal(got, guard)
    assert _bits_equal(got, again)
    if case != "adversarial":
        assert bool(torch.isfinite(got).all())
        if case == "deep":
            want = composite_tiles_bucket_bwd_plain(*args[:5], depth_grad)
            for f in range(10):
                scale = float(want[:, f].abs().max()) + 1e-12
                assert _knife_edge(got[:, f], want[:, f], scale), f


@pytest.mark.cuda
@pytest.mark.parametrize("screen", [0.0, 20.0])
def test_densify_and_prune_on_card_equals_cpu(cuda, screen):
    rng = np.random.default_rng(12)
    c, n = 8192, 5000
    params = random_gaussians(rng, n=n, capacity=c, spread=1.5,
                              scale_range=(-5.0, -1.5), device=cuda)
    with torch.no_grad():
        params.opacity[:n] = torch.tensor(
            rng.normal(-1.0, 3.0, (n, 1)).astype(np.float32), device=cuda)
    stats = (rng.random(c) * 30, rng.random(c) * 4e-4, rng.integers(0, 3, c))
    aux = GaussianAux(*(torch.tensor(a.astype(np.float32), device=cuda)
                        for a in stats))
    gen = torch.Generator(cuda).manual_seed(5)
    opt = AdamState(*({g: torch.randn(getattr(params, g).shape, device=cuda,
                                      generator=gen) for g in PARAM_GROUPS}
                      for _ in range(2)), step=3)
    noise = tuple(torch.randn((c, 3), generator=gen, device=cuda)
                  for _ in range(2))

    def cpu(x):
        return x.detach().cpu().clone()

    host = params_from_numpy({g: cpu(getattr(params, g)).numpy()
                              for g in PARAM_GROUPS}, params.sh_degree,
                             alive=cpu(params.alive).numpy(), device="cpu")
    host_aux = GaussianAux(*(cpu(getattr(aux, f)) for f in (
        "max_radii2d", "xyz_gradient_accum", "denom")))
    host_opt = AdamState(mu={g: cpu(v) for g, v in opt.mu.items()},
                         nu={g: cpu(v) for g, v in opt.nu.items()}, step=3)
    thresholds = (0.0002, 0.005, 10.0, screen, 0.01)
    _, _, _, info = densify_and_prune(params, aux, opt, noise, *thresholds)
    _, _, _, host_info = densify_and_prune(
        host, host_aux, host_opt, tuple(cpu(x) for x in noise), *thresholds)
    got = {k: int(v) for k, v in info.items()}
    assert got == {k: int(v) for k, v in host_info.items()}
    assert got["n_cloned"] > 0 and got["n_split"] > 0 and got["n_pruned"] > 0
    assert torch.equal(params.alive.cpu(), host.alive)
    for g in PARAM_GROUPS:
        want = getattr(host, g).detach()
        torch.testing.assert_close(getattr(params, g).detach().cpu(), want,
                                   rtol=0, atol=1e-6 * float(want.abs().max()))
        for m in ("mu", "nu"):
            assert torch.equal(getattr(opt, m)[g].cpu(),
                               getattr(host_opt, m)[g]), (m, g)


@pytest.mark.cuda
def test_composite_bwd_kernel_on_a_depth_loss(cuda, monkeypatch):
    """Kernel C at depth_grad=True on the cotangent a depth L1 gives (the
    invdepth row nonzero), against its plain version per field."""
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    params = random_gaussians(np.random.default_rng(0), n=4096, spread=1.5,
                              device=cuda)
    cams = ring_camera_batch(1, 120, 200, device=cuda)
    target = torch.rand((1, 1, 120, 200), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2))
    got = []
    real = rc.Composite.backward

    def backward(ctx, gtiles, gwalked):
        records, starts, counts, tiles = ctx.saved_tensors
        got.append((records, starts, counts, *ctx.geometry[:2],
                    gtiles[:, :rc.IMG_ROWS].clone(),
                    tiles[:, rc.IMG_ROWS:], ctx.geometry[2]))
        return real(ctx, gtiles, gwalked)

    monkeypatch.setattr(rc.Composite, "backward", staticmethod(backward))
    out = batch_render(params, cams, torch.zeros(3, device=cuda),
                       config=RasterConfig(depth_grad=True))
    loss = (torch.abs(out.render - cams.gt_image).mean()
            + torch.abs(out.invdepth - target).mean())
    loss.backward()
    monkeypatch.undo()
    (records, starts, counts, ntx, view_rows, gtiles, state, depth_grad), = got
    assert depth_grad is True
    assert float(gtiles[:, 3].abs().max()) > 0
    want = composite_tiles_bwd_plain(records, starts, counts, ntx, view_rows,
                                     gtiles, True)
    mine = composite_tiles_bwd(records, starts, counts, ntx, view_rows,
                               gtiles, state, True)
    assert bool(torch.isfinite(mine).all())
    for f in range(10):
        scale = float(want[:, f].abs().max()) + 1e-12
        assert _knife_edge(mine[:, f], want[:, f], scale), f
    assert float(mine[:, 9].abs().max()) > 0


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """LPIPS with random weights (the real file's shapes) on two pairs at
    136x200: the card's values within 1e-4 relative of the CPU's."""
    from chip_smoke import write_lpips_weights
    from gslm_tpu_torch.eval import lpips
    path = write_lpips_weights(str(tmp_path / "lpips.npz"))
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 3, 136, 200)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = lpips.lpips(torch.tensor(a), torch.tensor(b), weight_path=path)
    # the metric turns TF32 off inside the call, whatever the caller set
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    got = lpips.lpips(torch.tensor(a, device=cuda),
                      torch.tensor(b, device=cuda), weight_path=path)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_parity_matrix_quick_on_card(cuda):
    from gslm_tpu_torch.utils.paritycheck import VARIANTS, run_parity_matrix
    res = run_parity_matrix(quick=True)
    assert list(res["variants"]) == list(VARIANTS)
    bad = {k: v for k, v in res["variants"].items() if not v["ok"]}
    assert res["ok"] and not bad, bad


@pytest.mark.cuda
def test_dp_train_step_one_nccl_rank_equals_train_step(cuda):
    """A one-rank NCCL group: ``make_dp_train_step`` (its collectives run,
    on one rank the identity) equals ``train_step`` bit for bit on the
    small scene, every parameter, moment and statistic and the metrics."""
    import socket

    import torch.distributed as dist

    from gslm_tpu_torch.parallel import make_dp_train_step, make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
        assert dist.get_backend(mesh.group) == "nccl"
        kw = dict(rcfg=RasterConfig(), opt=OptimizationParams(),
                  active_sh_degree=3, use_exp=False, sparse_adam=False,
                  update_stats=True)
        cams = ring_camera_batch(1, 72, 96, device=cuda)
        bg = torch.zeros(3, device=cuda)
        runs = []
        for step in (lambda *a: train_step(*a, **kw),
                     make_dp_train_step(mesh, **kw)):
            params = random_gaussians(np.random.default_rng(3), n=2048,
                                      spread=1.5, device=cuda)
            aux = GaussianAux.zeros(2048, device=cuda)
            opt_state = init_adam(params)
            _, _, _, metrics = step(params, aux, opt_state, cams, bg, 100,
                                    1.0, 0.0)
            runs.append([getattr(params, g) for g in PARAM_GROUPS]
                        + [getattr(aux, f) for f in ("max_radii2d",
                                                     "xyz_gradient_accum",
                                                     "denom")]
                        + list(opt_state.mu.values())
                        + list(opt_state.nu.values()) + list(metrics.values()))
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    finally:
        dist.destroy_process_group()


def _knn_equals_plain(pts: np.ndarray, cuda) -> tuple:
    """Kernel F on ``pts`` twice against its plain version on the card:
    (bitwise equal to plain, bitwise repeatable)."""
    from gslm_tpu_torch.ops.knn import mean_sq_dist_3nn, mean_sq_dist_3nn_plain
    x = torch.tensor(pts, device=cuda)
    n0 = mean_sq_dist_3nn.launches
    a, b = mean_sq_dist_3nn(x), mean_sq_dist_3nn(x)
    assert mean_sq_dist_3nn.launches == n0 + 2
    want = mean_sq_dist_3nn_plain(x, chunk=256)
    torch.cuda.synchronize()
    return torch.equal(a, want), torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(hard_clouds()))
def test_knn_kernel_equals_plain(cuda, case):
    """Kernel F bit for bit against its plain version and itself on the
    clouds of tests/knn_cases.py: points on cell faces, coplanar,
    collinear and identical clouds, duplicates, P from 1 to 5, clusters
    with far outliers."""
    assert _knn_equals_plain(hard_clouds()[case], cuda) == (True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "clustered"])
def test_knn_kernel_equals_plain_at_size(cuda, case):
    """100,000 uniform points, and 100,000 in 8 clusters with 1 % outliers
    at 100x their spread."""
    rng = np.random.default_rng(7)
    pts = (rng.uniform(-1.5, 1.5, (100_000, 3)).astype(np.float32)
           if case == "uniform" else clustered_cloud(rng, 100_000))
    assert _knn_equals_plain(pts, cuda) == (True, True)


@pytest.mark.cuda
def test_knn_kernel_under_create_from_pcd(cuda):
    """``create_from_pcd`` without a given 3-NN launches kernel F once,
    its log-scales from F's distances; the pair-counting instantiation
    gives the same distances and at least min(P - 1, 3) pairs a point."""
    from gslm_tpu_torch.models.gaussians import create_from_pcd
    from gslm_tpu_torch.ops.knn import build_grid, mean_sq_dist_3nn, search
    rng = np.random.default_rng(8)
    pts, colors = rng.normal(0, 1, (5000, 3)), rng.random((5000, 3))
    n0 = mean_sq_dist_3nn.launches
    params, _ = create_from_pcd(pts, colors, num_images=2, device=cuda)
    assert mean_sq_dist_3nn.launches == n0 + 1
    x = torch.tensor(pts, dtype=torch.float32, device=cuda)
    msd = mean_sq_dist_3nn(x)
    want = torch.log(torch.sqrt(torch.clamp(msd, min=1e-7)))
    assert torch.equal(params.scaling[:5000, 0], want)
    out, pairs, _ = search(build_grid(x), count_pairs=True)
    assert torch.equal(out, msd) and int(pairs.min()) >= 3


def _view_splats(cuda, n, height, width, views=1, seed=0):
    """Seeded random Gaussians preprocessed for ``views`` ring views,
    stacked: (splats, tile columns, tile rows a view)."""
    params = random_gaussians(np.random.default_rng(seed), n=n, spread=1.5,
                              device=cuda)
    with torch.no_grad():
        splats, _, nty = stack_views(
            params, ring_camera_batch(views, height, width, device=cuda))
    return splats, -(-width // 16), nty


def _edge_splats(cuda, n=60_000, seed=11):
    """Seeded splats at the masks' edges, in three stacked views of 24
    tile rows: rects 0-70 units wide and tall (cw, ch up to 9, partial last
    cells; an empty rect clamps to one unit), means inside and beyond
    them, opacity under 1/255 (s2 < 0) and about the 1e-12 clamp, a and c
    log-uniform over [1e-14, 1] with some exactly at, under and at zero
    below the clamp, b² within 1e-7 to 1e-1 of a·c (and at it), tile_count
    0 on a sixth of the rows."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 50, n)
    y0 = rng.integers(0, 72, n)
    size = np.where(rng.random(n) < 0.5, rng.integers(0, 9, (2, n)),
                    rng.integers(0, 71, (2, n)))
    x1, y1 = x0 + size[0], y0 + size[1]
    count = np.where(rng.random(n) < 1 / 6, 0, size[0] * size[1])
    cx = (x0 + size[0] * rng.uniform(-0.3, 1.3, n)) * 16
    cy = ((y0 % 24) + size[1] * rng.uniform(-0.3, 1.3, n)) * 16
    a = 10.0 ** rng.uniform(-14, 0, n)
    c = 10.0 ** rng.uniform(-14, 0, n)
    for v, k in ((a, 0), (c, 1)):
        pick = rng.random(n)
        v[pick < 0.03] = np.float32(1e-12)
        v[(pick >= 0.03) & (pick < 0.05)] = 1e-13
        v[(pick >= 0.05) & (pick < 0.06)] = -1e-3 * (k + 1)
        v[(pick >= 0.06) & (pick < 0.07)] = 0.0
    near = np.sqrt(np.abs(a * c)) * (1 - 10.0 ** rng.uniform(-7, -1, n))
    b = np.where(rng.random(n) < 0.1, np.sqrt(np.abs(a * c)), near) \
        * rng.choice([-1.0, 1.0], n)
    op = rng.uniform(0, 1, n)
    pick = rng.random(n)
    op[pick < 0.2] = rng.uniform(0, 1 / 255, n)[pick < 0.2]
    op[(pick >= 0.2) & (pick < 0.25)] = (1e-12 / 255 * rng.uniform(
        0.5, 2, n))[(pick >= 0.2) & (pick < 0.25)]
    op[(pick >= 0.25) & (pick < 0.27)] = 0.0
    op[(pick >= 0.27) & (pick < 0.29)] = np.float32(1 / 255)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=cuda)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=cuda)

    return Splats2D(
        mean2d=f32(np.stack([cx, cy], -1)), conic=f32(np.stack([a, b, c], -1)),
        color=f32(np.zeros((n, 3))), opacity=f32(op), depth=f32(np.ones(n)),
        invdepth=f32(np.ones(n)), radius=i32(np.ones(n)),
        rect_min=i32(np.stack([x0, y0], -1)),
        rect_max=i32(np.stack([x1, y1], -1)), tile_count=i32(count),
        visible=torch.tensor(count > 0, device=cuda))


def _masks_equal(splats, view_rows, ntx, tile_px=16):
    """Kernel G on ``splats`` against the plain version, each of the five
    outputs bit for bit, and one launch."""
    cwb = max(rasterize_tiled._cdiv(ntx, 8).bit_length(), 1)
    n0 = rasterize_tiled._cell_masks.launches
    got = rasterize_tiled._cell_masks(splats, view_rows, cwb, tile_px)
    assert rasterize_tiled._cell_masks.launches == n0 + 1
    want = rasterize_tiled._cell_masks_plain(splats, view_rows, cwb, tile_px)
    torch.cuda.synchronize()
    assert len(got) == 5
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == torch.int32, k
        assert torch.equal(g, w), (k, int((g != w).sum()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [1, 2, 4])
def test_cell_masks_kernel_equals_plain(cuda, bucket):
    """The small scene's view (13x8 tiles) at tile_px 16, and on the bucket
    grids of 2 and 4 tiles (tile_px 32 and 64)."""
    splats, ntx, nty = _view_splats(cuda, 4096, 120, 200)
    if bucket > 1:
        splats = rasterize_tiled.bucket_splats(splats, bucket)
    got = _masks_equal(splats, nty // bucket,
                       rasterize_tiled._cdiv(ntx, bucket), 16 * bucket)
    assert int(got[4].sum()) > 1000


@pytest.mark.cuda
def test_cell_masks_kernel_on_stacked_views(cuda):
    """Two stacked views: the rows wrap modulo view_rows."""
    splats, ntx, nty = _view_splats(cuda, 4096, 120, 200, views=2, seed=3)
    assert int(splats.rect_min[:, 1].max()) >= nty
    _masks_equal(splats, nty, ntx)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_px", [16, 64])
def test_cell_masks_kernel_at_the_edges(cuda, tile_px):
    """``_edge_splats``: wide rects, thin opacities, near-degenerate and
    clamped conics, rows with tile_count 0."""
    splats = _edge_splats(cuda)
    assert int((splats.rect_max - splats.rect_min).max()) > 64
    got = _masks_equal(splats, 24, 60, tile_px)
    empty = splats.tile_count == 0
    assert bool((got[4][empty] == 0).all())
    assert bool((got[0][empty] != 0).any())        # words are kept there
    kept = got[4][~empty]
    assert bool((kept > 0).any()) and bool((kept == 0).any())


@pytest.mark.cuda
def test_cell_masks_kernel_on_packed_rows(cuda):
    """Fields that are column views of packed rows, as the model axis
    exchanges them (``parallel/model_raster._band_splats``): the wrapper
    copies them contiguous, and G gives its contiguous-input words."""
    splats = _edge_splats(cuda, n=20_000, seed=12)
    fl = torch.cat([splats.mean2d, splats.conic, splats.opacity[:, None],
                    torch.zeros(20_000, 5, device=cuda)], dim=1)
    it = torch.cat([splats.rect_min, splats.rect_max,
                    splats.tile_count[:, None]], dim=1)
    packed = splats.replace(mean2d=fl[:, 0:2], conic=fl[:, 2:5],
                            opacity=fl[:, 5], rect_min=it[:, 0:2],
                            rect_max=it[:, 2:4], tile_count=it[:, 4])
    assert packed.conic.stride(0) == 11 and packed.tile_count.stride(0) == 5
    got = _masks_equal(packed, 24, 60)
    want = rasterize_tiled._cell_masks(
        splats, 24, max(rasterize_tiled._cdiv(60, 8).bit_length(), 1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cell_masks_kernel_on_dual_splats(cuda):
    """Forward-AD duals (the LM solver's J·v renders) give the primal's
    words."""
    splats, ntx, nty = _view_splats(cuda, 4096, 120, 200)
    gen = torch.Generator(cuda).manual_seed(2)
    cwb = max(rasterize_tiled._cdiv(ntx, 8).bit_length(), 1)
    want = rasterize_tiled._cell_masks_plain(splats, nty, cwb)
    with fwAD.dual_level():
        dual = splats.replace(**{
            f: fwAD.make_dual(getattr(splats, f), torch.randn(
                getattr(splats, f).shape, device=cuda, generator=gen))
            for f in ("mean2d", "conic", "opacity")})
        got = rasterize_tiled._cell_masks(dual, nty, cwb)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cell_masks_kernel_at_size(cuda):
    """One 1080p view of 1,048,576 seeded Gaussians."""
    splats, ntx, nty = _view_splats(cuda, 1 << 20, 1080, 1920, seed=4)
    got = _masks_equal(splats, nty, ntx)
    assert int(got[4].sum()) > 1_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("views,bucket", [(1, 1), (2, 1), (1, 2)])
def test_duplicate_sort_ranges_with_kernel_g_equals_plain(cuda, monkeypatch,
                                                          views, bucket):
    """Stages 1-3 through kernel G (one launch) against the same stages on
    the plain masks: order, rank, starts, ends and both totals equal."""
    splats, ntx, nty = _view_splats(cuda, 4096, 120, 200, views=views, seed=6)
    if bucket > 1:
        splats = rasterize_tiled.bucket_splats(splats, bucket)
    args = (splats, rasterize_tiled._cdiv(ntx, bucket),
            views * nty // bucket, 1 << 16)
    kw = dict(view_rows=nty // bucket, cull=True, tile_px=16 * bucket)
    n0 = rasterize_tiled._cell_masks.launches
    got = rasterize_tiled.duplicate_sort_ranges(*args, **kw)
    assert rasterize_tiled._cell_masks.launches == n0 + 1
    monkeypatch.setattr(rasterize_tiled, "_cell_masks",
                        rasterize_tiled._cell_masks_plain)
    want = rasterize_tiled.duplicate_sort_ranges(*args, **kw)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    assert [int(t) for t in got[4]] == [int(t) for t in want[4]]
    assert int(got[4][0]) < int(got[4][1])          # the cull dropped some


def _fields_equal(got: Splats2D, want: Splats2D) -> dict:
    """Each field of two ``Splats2D``: {name: rows that differ}, float
    fields compared bit by bit (a NaN is never written: the fields are
    sanitized), shapes and dtypes equal."""
    out = {}
    for f in dataclasses.fields(Splats2D):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.shape == w.shape and g.dtype == w.dtype, f.name
        assert not g.requires_grad, f.name
        if g.dtype.is_floating_point:
            g, w = g.view(torch.int32), w.view(torch.int32)
        d = g != w
        out[f.name] = int((d if d.dim() == 1 else d.flatten(1).any(1)).sum())
    return out


def _kernel_h_equals_plain(params, cam, **kw):
    """Kernel H against the plain graph, every field bit for bit, one
    launch through ``preprocess``'s dispatch (no grad)."""
    n0, p0 = preprocess_cuda.launches, projection.preprocess_plain_cuda_calls
    with torch.no_grad():
        got = preprocess(params, cam, **kw)
        want = preprocess_plain(params, cam, **kw)
    torch.cuda.synchronize()
    assert preprocess_cuda.launches == n0 + 1
    assert projection.preprocess_plain_cuda_calls == p0
    differ = _fields_equal(got, want)
    assert not any(differ.values()), differ
    return got


def _h_camera(cuda, radius, azimuth, elevation, height=822, width=1237):
    wv, fp, cp, tx, ty = look_at(radius, azimuth, elevation, 60.0, height,
                                 width)

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=cuda)

    return Camera(world_view=t(wv), full_proj=t(fp), campos=t(cp),
                  tanfovx=t(tx), tanfovy=t(ty),
                  exposure_idx=torch.tensor(0, device=cuda), height=height,
                  width=width)


@pytest.fixture(scope="module")
def mip360_scene():
    """The ``mip360-3m`` scene law at full size: 3,103,446 Gaussians of SH
    degree 3 in a cube of half-side 1.5, log-scales in [-5.5, -3.5],
    opacity logits in [-1, 2], DC N(0, 0.5), higher SH N(0, 0.05)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    n = 3_103_446
    gen = torch.Generator(dev).manual_seed(21)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    yield GaussianParams(
        xyz=uniform((n, 3), -1.5, 1.5), features_dc=normal((n, 1, 3), 0.5),
        features_rest=normal((n, 15, 3), 0.05),
        scaling=uniform((n, 3), -5.5, -3.5), rotation=normal((n, 4), 1.0),
        opacity=uniform((n, 1), -1.0, 2.0),
        exposure=torch.eye(3, 4, device=dev)[None], sh_degree=3)
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("view", [(4.0, 0.0, 0.1), (4.0, 1.3, -0.2),
                                  (4.5, 2.2, 0.35)],
                         ids=["ring-a", "ring-b", "orbit-off-ring"])
def test_preprocess_kernel_on_mip360_views(cuda, mip360_scene, view):
    """Three 1237x822 views of the full-size scene, two on the training
    ring (radius 4) and one on the viewer's orbit off it (radius 4.5,
    elevation 0.35): every field bit for bit."""
    got = _kernel_h_equals_plain(mip360_scene, _h_camera(cuda, *view),
                                 active_sh_degree=3, alive=mip360_scene.alive)
    assert int(got.visible.sum()) > 2_500_000
    assert int(got.tile_count.sum()) > 5_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("antialiasing", [False, True])
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_preprocess_kernel_equals_plain(cuda, deg, antialiasing):
    """The small scene at every active SH degree of a degree-4 model
    (a degree-3 model too at degree 3), with and without antialiasing."""
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    for model_deg in sorted({max(deg, 3), 4}):
        params = random_gaussians(np.random.default_rng(deg), n=4096,
                                  spread=1.5, sh_degree=model_deg,
                                  device=cuda)
        got = _kernel_h_equals_plain(params, cam, active_sh_degree=deg,
                                     antialiasing=antialiasing)
        assert 0 < int(got.visible.sum()) < 4096


@pytest.mark.cuda
@pytest.mark.parametrize("scaling_modifier", [0.5, 1.7])
def test_preprocess_kernel_scaling_modifier(cuda, scaling_modifier):
    params = random_gaussians(np.random.default_rng(5), n=4096, spread=1.5,
                              device=cuda)
    cam = ring_camera_batch(2, 120, 200, device=cuda).view(1)
    _kernel_h_equals_plain(params, cam, active_sh_degree=3,
                           scaling_modifier=scaling_modifier,
                           antialiasing=True)


def _edge_params(cuda, cam, sh_degree=3):
    g = edge_groups(cam.world_view.cpu().numpy(), cam.width, cam.height,
                    float(cam.tanfovx), float(cam.tanfovy), sh_degree)
    g["exposure"] = np.eye(3, 4, dtype=np.float32)[None]
    return params_from_numpy(g, sh_degree, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("antialiasing", [False, True])
@pytest.mark.parametrize("deg", [3, 4])
def test_preprocess_kernel_at_the_edges(cuda, deg, antialiasing):
    """tests/preprocess_cases.py's rows: behind and about the near plane,
    off screen and on tile boundaries, opacity at and under 1/255,
    overflowing (det not > 0) and vanishing covariances, zero, huge and
    non-finite quaternions, non-finite means, scales, opacities and SH."""
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    params = _edge_params(cuda, cam, deg)
    tz = (params.xyz @ cam.world_view[2, :3]) + cam.world_view[2, 3]
    assert bool((tz <= 0.2).any()) and bool((tz > 0.2).any())
    got = _kernel_h_equals_plain(params, cam, active_sh_degree=deg,
                                 antialiasing=antialiasing)
    vis = got.visible
    assert 0 < int(vis.sum()) < vis.shape[0]
    assert bool((got.tile_count[~vis] == 0).all())
    assert bool((got.mean2d[~vis] == -1e4).all())


@pytest.mark.cuda
def test_preprocess_kernel_with_alive_override_and_offset(cuda):
    """``alive``, ``color_override`` (with non-finite rows) and
    ``mean2d_offset`` given, alone and together."""
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    params = _edge_params(cuda, cam)
    n = params.capacity
    gen = torch.Generator(cuda).manual_seed(7)
    alive = torch.rand(n, device=cuda, generator=gen) > 0.25
    offset = torch.randn(n, 2, device=cuda, generator=gen) * 0.01
    override = torch.rand(n, 3, device=cuda, generator=gen)
    override[::7, 1] = float("nan")
    override[::11, 2] = float("inf")
    kws = [dict(alive=alive), dict(color_override=override),
           dict(mean2d_offset=offset),
           dict(alive=alive, color_override=override, mean2d_offset=offset)]
    for kw in kws:
        _kernel_h_equals_plain(params, cam, active_sh_degree=3,
                               antialiasing=True, **kw)


@pytest.mark.cuda
def test_preprocess_kernel_on_no_gaussians(cuda):
    """P = 0: eleven empty fields, no launch."""
    params = random_gaussians(np.random.default_rng(0), n=1, device=cuda)
    empty = GaussianParams(**{g: getattr(params, g).detach()[:0]
                              for g in PARAM_GROUPS[:-1]},
                           exposure=params.exposure.detach(), sh_degree=3)
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    n0 = preprocess_cuda.launches
    with torch.no_grad():
        got = preprocess(empty, cam, active_sh_degree=3)
        want = preprocess_plain(empty, cam, active_sh_degree=3)
    assert preprocess_cuda.launches == n0
    assert not any(_fields_equal(got, want).values())
    assert got.visible.shape == (0,) and got.rect_min.shape == (0, 2)


@pytest.mark.cuda
def test_preprocess_kernel_rejects_what_it_cannot_take(cuda):
    """A float64 group, a camera left on the CPU, a mask of another dtype
    and an SH degree the coefficients do not hold raise."""
    params = random_gaussians(np.random.default_rng(0), n=256, device=cuda)
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    groups = {g: getattr(params, g).detach() for g in PARAM_GROUPS}
    with torch.no_grad():
        bad = GaussianParams(**(groups | {"xyz": groups["xyz"].double()}),
                             sh_degree=3)
        with pytest.raises(TypeError, match="xyz"):
            preprocess(bad, cam, active_sh_degree=3)
        cpu_cam = cam.replace(world_view=cam.world_view.cpu())
        with pytest.raises(TypeError, match="world_view"):
            preprocess(params, cpu_cam, active_sh_degree=3)
        with pytest.raises(TypeError, match="alive"):
            preprocess(params, cam, active_sh_degree=3,
                       alive=torch.ones(256, device=cuda))
        deg1 = GaussianParams(**(groups | {
            "features_rest": groups["features_rest"][:, :3]}), sh_degree=1)
        with pytest.raises(ValueError, match="SH degree"):
            preprocess(deg1, cam, active_sh_degree=2)


@pytest.mark.cuda
def test_preprocess_takes_the_plain_graph_under_autograd(cuda):
    """Grad mode with leaves that require grad, and forward-AD duals under
    ``no_grad`` (the LM solver's J·v), run the plain graph: kernel H is not
    launched, the plain calls are counted, gradients and tangents flow, and
    the values are kernel H's."""
    params = random_gaussians(np.random.default_rng(1), n=4096, spread=1.5,
                              device=cuda)
    cam = ring_camera_batch(1, 120, 200, device=cuda).view(0)
    with torch.no_grad():
        want = preprocess(params, cam, active_sh_degree=3)
    n0, p0 = preprocess_cuda.launches, projection.preprocess_plain_cuda_calls
    got = preprocess(params, cam, active_sh_degree=3)
    assert got.color.requires_grad
    (g,) = torch.autograd.grad(got.color.sum(), params.features_dc)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    gen = torch.Generator(cuda).manual_seed(2)
    groups = {k: v.detach() for k, v in params.groups().items()}
    with torch.no_grad(), fwAD.dual_level():
        dual = with_groups(params, {
            k: fwAD.make_dual(v, torch.randn(v.shape, device=cuda,
                                             generator=gen))
            for k, v in groups.items()})
        jv = preprocess(dual, cam, active_sh_degree=3)
        primal, tangent = fwAD.unpack_dual(jv.mean2d)
    assert tangent is not None and float(tangent.abs().sum()) > 0
    assert preprocess_cuda.launches == n0
    assert projection.preprocess_plain_cuda_calls == p0 + 2
    detached = got.replace(**{f: getattr(got, f).detach()
                              for f in ("mean2d", "conic", "color",
                                        "opacity", "depth", "invdepth")})
    assert not any(_fields_equal(detached, want).values())
    assert torch.equal(primal.view(torch.int32),
                       want.mean2d.view(torch.int32))


@pytest.mark.cuda
def test_kernel_h_launches_per_render_and_none_in_train_step(cuda):
    """One launch per ``render`` and per ``batch_render`` view under
    ``no_grad``; none in ``train_step`` (its preprocess needs autograd)."""
    params = random_gaussians(np.random.default_rng(4), n=4096, spread=1.5,
                              device=cuda)
    cams = ring_camera_batch(3, 120, 200, device=cuda)
    bg = torch.zeros(3, device=cuda)
    n0 = preprocess_cuda.launches
    with torch.no_grad():
        render(params, cams.view(0), bg)
        batch_render(params, cams, bg)
    assert preprocess_cuda.launches == n0 + 4
    p0 = projection.preprocess_plain_cuda_calls
    train_step(params, GaussianAux.zeros(4096, device=cuda),
               init_adam(params), cams.take(slice(0, 1)), bg, 100, 1.0, 0.0,
               rcfg=RasterConfig(), opt=OptimizationParams(),
               active_sh_degree=3, use_exp=False, sparse_adam=False,
               update_stats=True)
    torch.cuda.synchronize()
    assert preprocess_cuda.launches == n0 + 4
    assert projection.preprocess_plain_cuda_calls == p0 + 1
