"""gslm_tpu_torch's Adam step (config.py, optim.py, densify.py,
utils/general.py, the camera loss masks, solver/residuals.py, train.py)
against gslm_tpu on the same numpy inputs.

Tolerances: the option defaults, learning-rate schedules, densification
statistics on identical inputs and the camera masks match exactly;
``adam_step`` on identical gradients to 1e-6. A whole ``train_step`` (JAX
through its Pallas VJP compositor in interpret mode, the port through the
plain versions of kernels A, B and C): loss and metrics to 1e-5, every
gradient to 1e-5·max|g| per group, ``denom`` and ``max_radii2d`` exactly,
``xyz_gradient_accum`` (norms of gradients two codegens computed) to
1e-5·max. Updated parameters are compared only where |g| > 1e-3·max|g| of
their group: with eps = 1e-15 Adam's first step moves a parameter by about
±lr whatever the gradient's size, so where the gradient is tiny, rounding
noise in it can flip the sign of the update."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu import config as j_config
from gslm_tpu.densify import add_densification_stats as j_add_stats
from gslm_tpu.models.cameras import batch_from_metas as j_batch_from_metas
from gslm_tpu.models.gaussians import GaussianAux as JGaussianAux
from gslm_tpu.optim import adam_step as j_adam_step
from gslm_tpu.optim import group_learning_rates as j_group_lrs
from gslm_tpu.optim import init_adam as j_init_adam
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.solver.residuals import scalar_training_loss as j_loss_fn
from gslm_tpu.train import make_raster_config as j_make_raster_config
from gslm_tpu.train import train_step as j_train_step
from gslm_tpu.utils.general import expon_lr as j_expon_lr
from gslm_tpu.utils.general import get_expon_lr_func as j_get_expon_lr_func
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu_torch.config import (OptimizationParams, PipelineParams,
                                   TpuParams)
from gslm_tpu_torch.densify import add_densification_stats
from gslm_tpu_torch.models.cameras import batch_from_metas
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                             params_from_numpy)
from gslm_tpu_torch.optim import adam_step, group_learning_rates, init_adam
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.train import loss_and_grads, make_raster_config, train_step
from gslm_tpu_torch.utils.general import expon_lr, get_expon_lr_func
from gslm_tpu_torch.utils.synthetic import make_camera
from torch_threads import one_thread  # noqa: F401 (autouse)

STEPS = [0, 1, 7, 100, 999, 5000, 15000, 29999, 30000, 45000, -3]


def test_optimization_params_defaults_match():
    assert dataclasses.asdict(OptimizationParams()) == dataclasses.asdict(
        j_config.OptimizationParams())


@pytest.mark.parametrize("spatial_lr_scale", [1.0, 2.5])
def test_learning_rates_match_exactly(spatial_lr_scale):
    """Exact at the scale the Adam step runs (1.0). The schedules run in
    float32 through XLA's and PyTorch's own exp and log, which can differ
    in the last bit: at other scales the rates agree to one ulp."""
    for step in STEPS:
        want = j_group_lrs(j_config.OptimizationParams(), step,
                           spatial_lr_scale)
        got = group_learning_rates(OptimizationParams(), step,
                                   spatial_lr_scale)
        assert got.keys() == want.keys()
        for k in want:
            a, b = np.float32(float(got[k])), np.float32(want[k])
            if spatial_lr_scale == 1.0:
                assert a == b, (step, k)
            else:
                assert abs(a - b) <= np.spacing(b), (step, k)
        kw = dict(lr_delay_steps=500, lr_delay_mult=0.1, max_steps=30000)
        assert (np.float32(float(expon_lr(step, 0.01, 0.001, **kw)))
                == np.float32(j_expon_lr(step, 0.01, 0.001, **kw))), step
        assert (get_expon_lr_func(0.01, 0.001, **kw)(step)
                == j_get_expon_lr_func(0.01, 0.001, **kw)(step)), step


def _groups(rng, capacity, num_images):
    shapes = {"xyz": (capacity, 3), "features_dc": (capacity, 1, 3),
              "features_rest": (capacity, 15, 3), "scaling": (capacity, 3),
              "rotation": (capacity, 4), "opacity": (capacity, 1),
              "exposure": (num_images, 3, 4)}
    return {g: rng.normal(0, 1, shapes[g]).astype(np.float32)
            for g in PARAM_GROUPS}


@pytest.mark.parametrize("sparse", [False, True])
def test_adam_step_matches_jax(sparse):
    """Three Adam steps on identical numpy gradients: parameters and both
    moments to 1e-6, dense and with the visibility mask."""
    rng = np.random.default_rng(0)
    p0 = _groups(rng, 64, 3)
    jp, _ = j_random_gaussians(np.random.default_rng(0), n=64, num_images=3)
    jp = jp.replace(**{g: jnp.asarray(v) for g, v in p0.items()})
    tp = params_from_numpy(p0, 3, device="cpu")
    jst, tst = j_init_adam(jp), init_adam(tp)
    for it, step in enumerate((1, 2, 3)):
        grads = _groups(rng, 64, 3)
        vis = rng.uniform(size=64) < 0.6 if sparse else None
        jlr = j_group_lrs(j_config.OptimizationParams(), step, 1.0)
        jp, jst = j_adam_step(
            jp, jp.replace(**{g: jnp.asarray(v) for g, v in grads.items()}),
            jst, jlr, None if vis is None else jnp.asarray(vis))
        tp, tst = adam_step(
            tp, {g: torch.tensor(v) for g, v in grads.items()}, tst,
            group_learning_rates(OptimizationParams(), step, 1.0),
            None if vis is None else torch.tensor(vis))
        assert tst.step == int(jst.step) == it + 1
        for g in PARAM_GROUPS:
            for a, b in ((getattr(jp, g), getattr(tp, g)),
                         (getattr(jst.mu, g), tst.mu[g]),
                         (getattr(jst.nu, g), tst.nu[g])):
                np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                           atol=1e-6, err_msg=g)


def test_densification_stats_match_exactly():
    rng = np.random.default_rng(1)
    P = 300
    grads = rng.normal(0, 1e-3, (P, 2)).astype(np.float32)
    radii = (rng.integers(0, 9, P) * (rng.uniform(size=P) < 0.7)
             ).astype(np.int32)
    start = [rng.uniform(0, 5, P).astype(np.float32) for _ in range(3)]
    want = j_add_stats(JGaussianAux(
        alive=jnp.ones(P, bool), max_radii2d=jnp.asarray(start[0]),
        xyz_gradient_accum=jnp.asarray(start[1]),
        denom=jnp.asarray(start[2])), jnp.asarray(grads), jnp.asarray(radii))
    got = add_densification_stats(
        GaussianAux(*(torch.tensor(s) for s in start)), torch.tensor(grads),
        torch.tensor(radii))
    for f in ("max_radii2d", "xyz_gradient_accum", "denom"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def _metas(make, rng_seed, sizes):
    """Cameras with images, alpha masks and reliable depth maps (the second
    view smaller, so the batch pads it)."""
    rng = np.random.default_rng(rng_seed)
    metas = []
    for i, (h, w) in enumerate(sizes):
        m = make(height=h, width=w, angle=0.7 * i, exposure_idx=i)
        m.image = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
        m.alpha_mask = (rng.uniform(size=(1, h, w)) < 0.9).astype(np.float32)
        m.invdepthmap = rng.uniform(0, 0.5, (1, h, w)).astype(np.float32)
        m.depth_reliable = True
        m.depth_mask = (rng.uniform(size=(1, h, w)) < 0.8).astype(np.float32)
        metas.append(m)
    return metas


def test_camera_batch_loss_masks_match_jax():
    sizes = [(40, 56), (32, 48)]
    want = j_batch_from_metas(_metas(j_make_camera, 2, sizes))
    got = batch_from_metas(_metas(make_camera, 2, sizes), device="cpu")
    for f in ("gt_image", "alpha_mask", "invdepth_gt", "depth_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.pixel_valid().numpy(),
                                  np.asarray(want.pixel_valid()))


def test_make_raster_config_matches_jax():
    for n in (100, 5000, 131_072):
        want = j_make_raster_config(j_config.TpuParams(),
                                    j_config.PipelineParams(), 1080, 1920, n)
        got = make_raster_config(TpuParams(), PipelineParams(), 1080, 1920,
                                 n)
        for f in ("dup_capacity", "live_capacity", "cull", "antialiasing",
                  "impl"):
            assert getattr(got, f) == getattr(want, f), (n, f)


def test_train_step_matches_jax():
    """One ``train_step`` at step 100 with sparse Adam, the trained
    exposure, a depth-L1 weight of 0.5 and the statistics on."""
    rng = np.random.default_rng(0)
    jp, jaux = j_random_gaussians(rng, n=300, capacity=320, num_images=2,
                                  spread=1.5)
    groups = {g: np.asarray(getattr(jp, g)) for g in PARAM_GROUPS}
    tp = params_from_numpy(groups, 3, alive=np.asarray(jaux.alive),
                           device="cpu")
    sizes = [(64, 64)]
    jcam = j_batch_from_metas(_metas(j_make_camera, 3, sizes))
    cam = batch_from_metas(_metas(make_camera, 3, sizes), device="cpu")
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    opt, jopt = OptimizationParams(), j_config.OptimizationParams()
    kw = dict(active_sh_degree=3, use_exp=True)

    # gradients: the loss of JAX's train_step, differentiated by jax.grad
    jrcfg = JRasterConfig(dup_capacity=1 << 14, impl="pallas")

    def j_total(p, m2d):
        loss, info = j_loss_fn(p, jcam, jnp.asarray(bg), config=jrcfg,
                               lambda_dssim=jopt.lambda_dssim,
                               use_trained_exp=True, active_sh_degree=3,
                               alive=jaux.alive, mean2d_offset=m2d)
        inv = info["render"].invdepth
        depth_l1 = (jnp.sum(jnp.abs(inv - jcam.invdepth_gt) * jcam.depth_mask)
                    / jnp.maximum(jnp.sum(jcam.depth_mask), 1.0))
        return loss + 0.5 * depth_l1

    jg, jm2d = jax.grad(j_total, argnums=(0, 1))(
        jp, jnp.zeros((320, 2), jnp.float32))
    rcfg = RasterConfig(dup_capacity=1 << 14)
    _, _, _, tg, tm2d = loss_and_grads(tp, cam, torch.tensor(bg), 0.5,
                                       rcfg=rcfg, opt=opt, **kw)
    for name, g, want in zip(list(PARAM_GROUPS) + ["mean2d_offset"],
                             [tg[k] for k in PARAM_GROUPS] + [tm2d],
                             [getattr(jg, k) for k in PARAM_GROUPS] + [jm2d]):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)

    jp2, jaux2, jst2, jm = j_train_step(
        jp, jaux, j_init_adam(jp), jcam, jnp.asarray(bg), 100, 1.0, 0.5,
        rcfg=jrcfg, opt=jopt, sparse_adam=True, update_stats=True, **kw)
    tp2, aux2, st2, tm = train_step(
        tp, GaussianAux.zeros(320, device="cpu"), init_adam(tp), cam,
        torch.tensor(bg), 100, 1.0, 0.5, rcfg=rcfg, opt=opt,
        sparse_adam=True, update_stats=True, **kw)
    assert tm.keys() == jm.keys()
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    assert float(tm["depth_l1"]) > 0
    for f in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(aux2, f).numpy(),
                                      np.asarray(getattr(jaux2, f)), f)
    acc = np.asarray(jaux2.xyz_gradient_accum)
    np.testing.assert_allclose(aux2.xyz_gradient_accum.numpy(), acc,
                               atol=1e-5 * acc.max())
    assert st2.step == int(jst2.step) == 1
    for g in PARAM_GROUPS:
        grad = np.abs(tg[g].numpy())
        big = grad > 1e-3 * grad.max()
        assert big.any(), g
        np.testing.assert_allclose(getattr(tp2, g).detach().numpy()[big],
                                   np.asarray(getattr(jp2, g))[big],
                                   atol=1e-6, err_msg=g)
