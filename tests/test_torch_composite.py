"""gslm_tpu_torch forward rasterizer (ops/rasterize_cuda.py, kernel A's
module) against gslm_tpu's Pallas forward compositor in interpret mode.

On the CPU the module composites through kernel A's plain version. Both
get the same ``Splats2D`` (the JAX preprocess output, as numpy).
Tolerances are those of tests/test_pallas.py: an opaque, well-separated
blob scene agrees to 1e-5; on a random scene the two evaluate exp/log in
different code, so a splat sitting exactly on the 1/255 gate can flip
(knife edges): mean |Δ| < 2e-4 and at most 1% of pixels with |Δ| > 1e-3.
The card test holds kernel A against the plain version at the same
random-scene bounds (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.ops.projection import preprocess as j_preprocess
from gslm_tpu.ops.rasterize_pallas import rasterize_pallas as j_rasterize_pallas
from gslm_tpu.ops.rasterize_ref import rasterize_ref as j_rasterize_ref
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu_torch.ops.projection import Splats2D
from gslm_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                               composite_tiles_plain,
                                               rasterize_cuda, tile_records)
from gslm_tpu_torch.ops.rasterize_ref import rasterize_ref
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from tests.synthetic_scene import blob_params
from torch_threads import one_thread  # noqa: F401 (autouse)

CAP = 1 << 12


def _to_port(js, device="cpu") -> Splats2D:
    return Splats2D(**{k: torch.tensor(np.asarray(v), device=device)
                       for k, v in vars(js).items()})


def _scene(params, h, w, radius=4.0):
    meta = j_make_camera(height=h, width=w, radius=radius)
    return j_preprocess(params, j_camera_from_meta(meta),
                        active_sh_degree=params.sh_degree)


def _pair(js, h, w, bg):
    a = j_rasterize_pallas(js, h, w, jnp.asarray(bg),
                           JRasterConfig(dup_capacity=CAP), interpret=True)
    b = rasterize_cuda(_to_port(js), h, w, torch.tensor(bg),
                       RasterConfig(dup_capacity=CAP))
    return a, b


@pytest.fixture(scope="module")
def random_scene():
    jp, _ = j_random_gaussians(np.random.default_rng(0), n=128)
    return _scene(jp, 48, 64)


def test_blob_matches_pallas():
    js = _scene(blob_params(num_images=1), 64, 64, radius=5.0)
    a, b = _pair(js, 64, 64, np.zeros(3, np.float32))
    np.testing.assert_allclose(b["render"].numpy(), np.asarray(a["render"]),
                               atol=1e-5)
    assert int(b["overflow"]) == 0


def test_random_scene_matches_pallas(random_scene):
    bg = np.array([0.2, 0.5, 0.8], np.float32)
    a, b = _pair(random_scene, 48, 64, bg)
    d = np.abs(b["render"].numpy() - np.asarray(a["render"]))
    assert d.mean() < 2e-4
    assert (d > 1e-3).mean() <= 0.01
    assert np.isfinite(b["render"].numpy()).all()
    for k in ("n_duplicates", "overflow", "max_tile_load"):
        assert int(b[k]) == int(a[k]), k


def test_invdepth_and_empty_tiles_match_pallas():
    js = _scene(blob_params(num_images=1), 48, 80, radius=5.0)
    bg = np.array([1.0, 0.0, 0.0], np.float32)
    a, b = _pair(js, 48, 80, bg)
    np.testing.assert_allclose(b["invdepth"].numpy(),
                               np.asarray(a["invdepth"]), atol=1e-5)
    # the empty corner tile renders pure background
    np.testing.assert_allclose(b["render"][:, 0, 0].numpy(), bg, atol=1e-6)


def test_matches_dense_reference(random_scene):
    """Port vs the dense golden rasterizer of both packages, on a scene
    far under max_per_tile (the tile walk covers every record)."""
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    ref_j = j_rasterize_ref(random_scene, 48, 64, jnp.asarray(bg))
    ref_t = rasterize_ref(_to_port(random_scene), 48, 64, torch.tensor(bg))
    np.testing.assert_allclose(ref_t["render"].numpy(),
                               np.asarray(ref_j["render"]), atol=1e-5)
    out = rasterize_cuda(_to_port(random_scene), 48, 64, torch.tensor(bg),
                         RasterConfig(dup_capacity=CAP))
    assert int(out["max_tile_load"]) < 1024
    for k in ("render", "invdepth"):
        d = np.abs(out[k].numpy() - np.asarray(ref_j[k]))
        assert d.mean() < 2e-4, k
        assert (d > 1e-3).mean() <= 0.01, k


def test_plain_composite_chunking_is_exact(random_scene):
    """The plain version's result does not depend on how tiles are
    chunked (what keeps batched renders bitwise equal to single views)."""
    records, starts, counts, *_ = tile_records(
        _to_port(random_scene), 4, 3, RasterConfig(dup_capacity=CAP))
    a, walked = composite_tiles(records, starts, counts, 4, 3)
    b, _ = composite_tiles_plain(records, starts, counts, 4, 3, max_elems=1)
    assert torch.equal(a, b)
    assert torch.equal(walked, counts)

