"""The public helpers of gslm_tpu that gslm_tpu_torch lacked, against
gslm_tpu on the same numpy inputs: the ``GaussianParams`` accessors
(``get_opacity``, ``get_rotation``, ``get_covariance``, ``num_images``,
``num_alive``), ``utils.general.build_scaling_rotation`` and
``covariance_from_scaling_rotation``, ``utils.image.l1_loss`` and
``l1_loss_per_pixel``, ``preprocess(color_override=)`` and
``mean_sq_dist_3nn(chunk=)``.

Tolerances: elementwise activations and losses within 1e-6 relative,
covariances within 1e-6 of their largest entry (a few ulp of the 3x3
products), counts exactly, the preprocess as tests/test_torch_preprocess.py
holds it (floats atol 1e-6, integers exactly), the 3-NN as
tests/test_torch_data_io.py holds it against JAX (rtol 5e-4: JAX's
‖a‖²+‖b‖²−2a·b cancels) and bit for bit across chunk sizes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.ops.knn import mean_sq_dist_3nn as j_knn
from gslm_tpu.ops.projection import preprocess as j_preprocess
from gslm_tpu.utils import general as j_general
from gslm_tpu.utils import image as j_image
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu_torch.models.cameras import camera_from_arrays
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, params_from_numpy,
                                             with_groups)
from gslm_tpu_torch.ops.knn import mean_sq_dist_3nn
from gslm_tpu_torch.ops.projection import preprocess
from gslm_tpu_torch.utils import general, image
from torch_threads import one_thread  # noqa: F401 (autouse)

FLOAT_FIELDS = ("mean2d", "conic", "color", "opacity", "depth", "invdepth")
INT_FIELDS = ("radius", "rect_min", "rect_max", "tile_count", "visible")


@pytest.fixture(scope="module")
def scene():
    jp, jaux = j_random_gaussians(np.random.default_rng(4), n=100,
                                  capacity=128, num_images=5)
    tp = params_from_numpy({g: np.asarray(getattr(jp, g))
                            for g in PARAM_GROUPS}, jp.sh_degree,
                           alive=np.asarray(jaux.alive), device="cpu")
    return jp, jaux, tp


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kind", ["params", "tensors"])
def test_gaussian_accessors_match_jax(scene, kind):
    """On ``GaussianParams`` and on ``GaussianTensors`` alike."""
    jp, jaux, tp = scene
    p = tp if kind == "params" else with_groups(tp, tp.groups())
    _close(p.get_opacity(), jp.get_opacity())
    _close(p.get_rotation(), jp.get_rotation())
    for mod in (1.0, 0.5):
        _close(p.get_covariance(mod), jp.get_covariance(mod))
    assert p.num_images == jp.num_images == 5
    assert p.num_alive.dtype == torch.int32
    assert int(p.num_alive) == int(jaux.num_alive) == 100


def test_covariance_helpers_match_jax():
    rng = np.random.default_rng(5)
    scale = np.exp(rng.uniform(-4, 0, (64, 3))).astype(np.float32)
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    _close(general.build_scaling_rotation(torch.tensor(scale),
                                          torch.tensor(q)),
           j_general.build_scaling_rotation(jnp.asarray(scale),
                                            jnp.asarray(q)))
    cov = general.covariance_from_scaling_rotation(torch.tensor(scale),
                                                   torch.tensor(q))
    assert cov.shape == (64, 6)
    _close(cov, j_general.covariance_from_scaling_rotation(
        jnp.asarray(scale), jnp.asarray(q)))


def test_l1_losses_match_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.random((2, 3, 16, 24)).astype(np.float32) for _ in range(2))
    _close(image.l1_loss(torch.tensor(a), torch.tensor(b)),
           j_image.l1_loss(jnp.asarray(a), jnp.asarray(b)))
    _close(image.l1_loss_per_pixel(torch.tensor(a), torch.tensor(b)),
           j_image.l1_loss_per_pixel(jnp.asarray(a), jnp.asarray(b)))


def test_preprocess_color_override_matches_jax(scene):
    """The override replaces the SH colours, non-finite entries zeroed."""
    jp, jaux, tp = scene
    colors = np.random.default_rng(7).random((128, 3)).astype(np.float32)
    colors[3] = [np.nan, np.inf, 0.5]
    meta = j_make_camera(height=48, width=64)
    js = j_preprocess(jp, j_camera_from_meta(meta), active_sh_degree=3,
                      alive=jaux.alive, color_override=jnp.asarray(colors))
    ts = preprocess(tp, camera_from_arrays(meta.R, meta.T, meta.fovx,
                                           meta.fovy, meta.width, meta.height,
                                           device="cpu"),
                    active_sh_degree=3, alive=tp.alive,
                    color_override=torch.tensor(colors))
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(ts, f).detach().numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-6,
                                   err_msg=f)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    want = np.nan_to_num(colors, nan=0.0, posinf=0.0, neginf=0.0)
    assert np.array_equal(ts.color.numpy(), want)


def test_mean_sq_dist_3nn_chunk():
    rng = np.random.default_rng(8)
    pts = (rng.normal(0, 1.0, (700, 3)) + 5.0).astype(np.float32)
    pts[9] = pts[2]
    got = {c: mean_sq_dist_3nn(torch.tensor(pts), chunk=c)
           for c in (1, 7, 256, 1024, 5000)}
    for c, v in got.items():
        assert torch.equal(v, got[1024]), c
    np.testing.assert_allclose(
        got[1024].numpy(), np.asarray(j_knn(jnp.asarray(pts), chunk=256)),
        rtol=5e-4)
    assert float(got[1024][9]) == float(got[1024][2])
