"""gslm_tpu_torch tile front-end (duplicate → sort → ranges, cell masks)
against gslm_tpu. The in-tile order is part of the contract, so ``order``,
``rank``, ``starts``, ``ends``, the totals and the cell-mask words must be
exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gslm_tpu.models.cameras import Camera as JCamera
from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.ops import rasterize_tiled as jrt
from gslm_tpu.ops.projection import Splats2D as JSplats2D
from gslm_tpu.ops.projection import preprocess as j_preprocess
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.models.cameras import camera_from_arrays
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops import rasterize_tiled as trt
from gslm_tpu_torch.ops.projection import preprocess as t_preprocess
from gslm_tpu_torch.renderer import stack_views
from gslm_tpu_torch.utils.synthetic import ring_camera_batch
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W = 48, 64
NTX, NTY = 4, 3


def _port_params(jp):
    return params_from_numpy({g: np.asarray(getattr(jp, g))
                              for g in PARAM_GROUPS}, jp.sh_degree,
                             device="cpu")


@pytest.fixture(scope="module")
def single_view():
    jp, _ = j_random_gaussians(np.random.default_rng(0), n=128)
    meta = j_make_camera(height=H, width=W)
    js = j_preprocess(jp, j_camera_from_meta(meta), active_sh_degree=3)
    cam = camera_from_arrays(meta.R, meta.T, meta.fovx, meta.fovy, W, H,
                             device="cpu")
    ts = t_preprocess(_port_params(jp), cam, active_sh_degree=3)
    return js, ts


def _assert_same_ranges(jo, to):
    order, rank, starts, ends, totals = to
    n = int(ends[-1])
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo[0]))
    assert rank.shape == (n,)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jo[1])[:n])
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jo[2]))
    np.testing.assert_array_equal(ends.numpy(), np.asarray(jo[3]))
    assert [int(t) for t in totals] == [int(t) for t in jo[4]]


@pytest.mark.parametrize("cull", [False, True])
def test_duplicate_sort_ranges_matches_jax(single_view, cull):
    js, ts = single_view
    L = 1 << 12
    jo = jrt.duplicate_sort_ranges(js, NTX, NTY, L, cull=cull)
    to = trt.duplicate_sort_ranges(ts, NTX, NTY, L, cull=cull)
    assert int(to[3][-1]) > 100
    _assert_same_ranges(jo, to)


def test_cell_masks_match_jax(single_view):
    js, ts = single_view
    cwb = max(trt._cdiv(NTX, 8).bit_length(), 1)
    for a, b in zip(jrt._cell_masks(js, NTY, cwb),
                    trt._cell_masks(ts, NTY, cwb)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_overflow_totals_match_jax(single_view):
    """Under a starved capacity both report the same totals (the images
    are discarded by callers then, so only the counts are compared)."""
    js, ts = single_view
    for cull, L, live in ((True, 200, 150), (False, 120, 0)):
        jo = jrt.duplicate_sort_ranges(js, NTX, NTY, L, cull=cull,
                                       live_capacity=live)
        to = trt.duplicate_sort_ranges(ts, NTX, NTY, L, cull=cull,
                                       live_capacity=live)
        assert [int(t) for t in to[4]] == [int(t) for t in jo[4]]
        assert int(to[4][1]) > L
        assert int(to[3][-1]) <= (live or L)


def test_two_view_stack_matches_jax():
    """2-view vertical stack: tile rows wrap modulo view_rows."""
    jp, _ = j_random_gaussians(np.random.default_rng(1), n=128)
    jb = j_ring_camera_batch(2, H, W)
    cam = JCamera(world_view=jb.world_view, full_proj=jb.full_proj,
                  campos=jb.campos, tanfovx=jb.tanfovx, tanfovy=jb.tanfovy,
                  exposure_idx=jb.exposure_idx, height=H, width=W)
    sv = jax.vmap(lambda c: j_preprocess(jp, c, active_sh_degree=3))(cam)
    voff = jnp.arange(2, dtype=jnp.int32)[:, None] * NTY

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])

    js = JSplats2D(
        mean2d=flat(sv.mean2d), conic=flat(sv.conic), color=flat(sv.color),
        opacity=flat(sv.opacity), depth=flat(sv.depth),
        invdepth=flat(sv.invdepth), radius=flat(sv.radius),
        rect_min=flat(sv.rect_min.at[..., 1].add(voff)),
        rect_max=flat(sv.rect_max.at[..., 1].add(voff)),
        tile_count=flat(sv.tile_count), visible=flat(sv.visible))
    ts, _, nty = stack_views(_port_params(jp),
                             ring_camera_batch(2, H, W, device="cpu"))
    assert nty == NTY
    np.testing.assert_array_equal(ts.rect_min.numpy(), np.asarray(js.rect_min))
    L = 1 << 12
    for cull in (False, True):
        jo = jrt.duplicate_sort_ranges(js, NTX, 2 * NTY, L, view_rows=NTY,
                                       cull=cull)
        to = trt.duplicate_sort_ranges(ts, NTX, 2 * NTY, L, view_rows=NTY,
                                       cull=cull)
        _assert_same_ranges(jo, to)
