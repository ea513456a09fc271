"""gslm_tpu_torch preprocess / SH / synthetic fixtures against gslm_tpu.

Both packages get the same numpy inputs (drawn from one seed); JAX runs on
the CPU. Tolerances: float fields atol 1e-6 (the two frameworks round a few
intermediate products differently, a few ulp); integer fields and masks
exactly equal."""

import contextlib

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax.numpy as jnp

from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.ops import sh as j_sh
from gslm_tpu.ops.projection import preprocess as j_preprocess
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.models.cameras import camera_from_arrays
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops import projection
from gslm_tpu_torch.ops import sh as t_sh
from gslm_tpu_torch.ops.projection import needs_autograd
from gslm_tpu_torch.ops.projection import preprocess as t_preprocess
from gslm_tpu_torch.utils.synthetic import make_camera, random_gaussians
from gslm_tpu_torch.utils.synthetic import ring_camera_batch
from torch_threads import one_thread  # noqa: F401 (autouse)

FLOAT_FIELDS = ("mean2d", "conic", "color", "opacity", "depth", "invdepth")
INT_FIELDS = ("radius", "rect_min", "rect_max", "tile_count", "visible")


def _port_params(jp, alive=None):
    return params_from_numpy({g: np.asarray(getattr(jp, g))
                              for g in PARAM_GROUPS}, jp.sh_degree,
                             alive=alive, device="cpu")


def _port_camera(meta):
    return camera_from_arrays(meta.R, meta.T, meta.fovx, meta.fovy,
                              meta.width, meta.height,
                              exposure_idx=meta.exposure_idx, device="cpu")


@pytest.mark.parametrize("antialiasing", [False, True])
def test_preprocess_matches_jax(antialiasing):
    rng = np.random.default_rng(0)
    jp, aux = j_random_gaussians(rng, n=128, capacity=160)
    meta = j_make_camera(height=48, width=64)
    js = j_preprocess(jp, j_camera_from_meta(meta), active_sh_degree=3,
                      antialiasing=antialiasing, alive=aux.alive)
    tp = _port_params(jp, alive=np.asarray(aux.alive))
    ts = t_preprocess(tp, _port_camera(meta), active_sh_degree=3,
                      antialiasing=antialiasing, alive=tp.alive)
    assert 0 < int(np.asarray(js.visible).sum()) < 160
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(ts, f).detach().numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-6,
                                   err_msg=f)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(64, 16, 3)).astype(np.float32)
    a = np.asarray(j_sh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    b = t_sh.eval_sh(deg, torch.tensor(coeffs), torch.tensor(dirs)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6)
    rgb = rng.uniform(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(t_sh.rgb2sh(torch.tensor(rgb)).numpy(),
                               np.asarray(j_sh.rgb2sh(jnp.asarray(rgb))),
                               atol=1e-6)
    np.testing.assert_allclose(t_sh.sh2rgb(torch.tensor(rgb)).numpy(),
                               np.asarray(j_sh.sh2rgb(jnp.asarray(rgb))),
                               atol=1e-6)


def test_synthetic_fixtures_match_jax():
    """Same seed → the same scene, cameras and ground truth in both."""
    jp, aux = j_random_gaussians(np.random.default_rng(3), n=40, capacity=48,
                                 spread=1.5, scale_range=(-5.5, -3.5))
    tp = random_gaussians(np.random.default_rng(3), n=40, capacity=48,
                          spread=1.5, scale_range=(-5.5, -3.5), device="cpu")
    for g in PARAM_GROUPS:
        np.testing.assert_array_equal(getattr(tp, g).detach().numpy(),
                                      np.asarray(getattr(jp, g)), err_msg=g)
    np.testing.assert_array_equal(tp.alive.numpy(), np.asarray(aux.alive))

    jb = j_ring_camera_batch(3, 24, 40)
    tb = ring_camera_batch(3, 24, 40, device="cpu")
    for f in ("world_view", "full_proj", "campos", "tanfovx", "tanfovy",
              "gt_image"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    jm, tm = j_make_camera(30, 50, angle=0.7), make_camera(30, 50, angle=0.7)
    np.testing.assert_array_equal(tm.full_proj, jm.full_proj)
    np.testing.assert_array_equal(tm.camera_center, jm.camera_center)


def test_sh_degree_4_matches_jax():
    """Degree 4 (25 coefficients, 24 ``features_rest`` rows): the basis,
    ``eval_sh`` and a whole preprocess against JAX."""
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(64, 25, 3)).astype(np.float32)
    assert t_sh.MAX_SH_DEGREE == j_sh.MAX_SH_DEGREE == 4
    np.testing.assert_allclose(
        t_sh.sh_basis(4, torch.tensor(dirs)).numpy(),
        np.asarray(j_sh.sh_basis(4, jnp.asarray(dirs))), atol=1e-6)
    np.testing.assert_allclose(
        t_sh.eval_sh(4, torch.tensor(coeffs), torch.tensor(dirs)).numpy(),
        np.asarray(j_sh.eval_sh(4, jnp.asarray(coeffs), jnp.asarray(dirs))),
        atol=1e-5)
    with pytest.raises(ValueError, match="SH degree 5"):
        t_sh.sh_basis(5, torch.tensor(dirs))

    jp, aux = j_random_gaussians(np.random.default_rng(5), n=96, sh_degree=4)
    assert jp.features_rest.shape == (96, 24, 3)
    meta = j_make_camera(height=48, width=64)
    js = j_preprocess(jp, j_camera_from_meta(meta), active_sh_degree=4,
                      alive=aux.alive)
    tp = _port_params(jp, alive=np.asarray(aux.alive))
    ts = t_preprocess(tp, _port_camera(meta), active_sh_degree=4,
                      alive=tp.alive)
    assert int(np.asarray(js.visible).sum()) > 0
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(ts, f).detach().numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-6,
                                   err_msg=f)


def _dispatch_inputs(case):
    """(context, the tensors ``preprocess`` would read, whether the plain
    graph's autograd is needed) for one case of the dispatch rule."""
    params = random_gaussians(np.random.default_rng(0), n=16, device="cpu")
    cam = ring_camera_batch(1, 24, 40, device="cpu").view(0)
    offset = torch.zeros(16, 2, requires_grad=case.endswith("offset"))
    inputs = projection._inputs(params, cam, offset if "offset" in case
                                else None, None)
    if case.startswith("dual"):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        stack.enter_context(fwAD.dual_level())
        if case == "dual":
            xyz = fwAD.make_dual(params.xyz.detach(), torch.ones(16, 3))
            inputs = (xyz,) + inputs[1:]
        else:                         # a dual level with no dual in it
            inputs = tuple(None if t is None else t.detach() for t in inputs)
        return stack, inputs, case == "dual"
    ctx = {"no_grad": torch.no_grad(), "inference": torch.inference_mode(),
           "grad": contextlib.nullcontext(),
           "grad_detached": contextlib.nullcontext(),
           "grad_offset": contextlib.nullcontext(),
           "no_grad_offset": torch.no_grad()}[case]
    if case == "grad_detached":
        inputs = tuple(None if t is None else t.detach() for t in inputs)
    return ctx, inputs, case in ("grad", "grad_offset")


@pytest.mark.parametrize("case", ["no_grad", "inference", "grad",
                                  "grad_detached", "grad_offset",
                                  "no_grad_offset", "dual", "dual_level"])
def test_needs_autograd_is_the_dispatch_rule(case):
    """Kernel H takes exactly the calls that need no autograd: grad mode
    off (``no_grad``, ``inference_mode``) or no input that requires grad,
    and no forward-AD tangent. Parameters (``nn.Parameter``, requiring
    grad) under grad mode, a ``mean2d_offset`` that requires grad, and a
    dual tensor under ``no_grad`` (the LM solver's J·v) need the plain
    graph; a dual level alone does not."""
    ctx, inputs, want = _dispatch_inputs(case)
    with ctx:
        assert needs_autograd(inputs) is want
    assert needs_autograd([None, torch.zeros(2)]) is False


def test_cpu_tensors_take_the_plain_graph():
    """On CPU tensors ``preprocess`` runs the plain graph under any grad
    mode: no kernel launch and no plain CUDA call counted, and its fields
    are ``preprocess_plain``'s bit for bit."""
    params = random_gaussians(np.random.default_rng(2), n=96, device="cpu")
    cam = ring_camera_batch(1, 48, 64, device="cpu").view(0)
    n0 = projection.preprocess_cuda.launches
    p0 = projection.preprocess_plain_cuda_calls
    with torch.no_grad():
        got = t_preprocess(params, cam, active_sh_degree=3,
                           antialiasing=True, alive=params.alive)
        want = projection.preprocess_plain(params, cam, active_sh_degree=3,
                                           antialiasing=True,
                                           alive=params.alive)
    graded = t_preprocess(params, cam, active_sh_degree=3)
    assert graded.color.requires_grad
    assert projection.preprocess_cuda.launches == n0
    assert projection.preprocess_plain_cuda_calls == p0
    for f in FLOAT_FIELDS + INT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
