"""gslm_tpu_torch's Levenberg–Marquardt step (config.LMParams, the LM
vector algebra of models/gaussians.py, solver/residuals.py,
solver/operators.py, solver/cg.py, RasterConfig.grow,
renderer.overflow_probe, train_lm.py) against gslm_tpu on the same numpy
inputs (the LM operators' parity is in tests/test_torch_jvp.py).

JAX renders with ``impl="pallas"`` (its Pallas compositors in interpret
mode; J·v through the ``pallas_jvp`` twin), the port through the plain
versions of kernels A, C and E (CPU tensors). Tolerances: option defaults,
masks, window and val indices, probe counts and grown capacities exactly;
vector algebra to 1e-6 relative; residuals to 1e-5·max (with SSIM their
squares over the weights, at the image bound and twice the SSIM map's);
the CG
solvers on a dense problem to rtol 1e-5; ``lm_outer_step`` with its
``best_alpha`` equal and its losses and new parameters to rtol 1e-4
(atol 1e-6·max|θ| per group for parameters near 0), in the default and
both staged line-search variants."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu import config as j_config
from gslm_tpu.models import gaussians as JG
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.renderer import overflow_probe as j_overflow_probe
from gslm_tpu.solver import cg as j_cg
from gslm_tpu.solver.residuals import batch_residuals as j_batch_residuals
from gslm_tpu.train_lm import downscale_val_batch as j_downscale
from gslm_tpu.train_lm import lm_outer_step as j_lm_outer_step
from gslm_tpu.train_lm import select_window as j_select_window
from gslm_tpu.train_lm import val_indices as j_val_indices
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.config import LMParams
from gslm_tpu_torch.models import gaussians as G
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.renderer import batch_render, overflow_probe
from gslm_tpu_torch.solver import cg
from gslm_tpu_torch.solver.residuals import (ResidualState, batch_residuals,
                                             res_dot, res_saxpy, res_scale)
from gslm_tpu_torch.train_lm import (downscale_val_batch, lm_outer_step,
                                     lm_phase, select_window, val_indices)
from gslm_tpu_torch.utils.synthetic import ring_camera_batch

H, W, NVIEWS, CAP = 48, 64, 6, 1 << 13
N, CAPACITY = 200, 224          # the last 24 slots are dead


@pytest.fixture(scope="module")
def lm_scene():
    """The same scene in both packages: 200 live Gaussians in 224 slots, 6
    ring views of 48x64 whose ground truth is the port's render of the
    scene with ``features_dc`` shifted (a reachable target)."""
    jp, jaux = j_random_gaussians(np.random.default_rng(0), n=N,
                                  capacity=CAPACITY, num_images=NVIEWS,
                                  spread=1.0)
    groups = {g: np.asarray(getattr(jp, g)) for g in PARAM_GROUPS}
    alive = np.asarray(jaux.alive)
    params = params_from_numpy(groups, 3, alive=alive, device="cpu")
    shifted = dict(groups, features_dc=groups["features_dc"] + np.random.
                   default_rng(1).normal(0, 0.2, groups["features_dc"].shape)
                   .astype(np.float32))
    cams = ring_camera_batch(NVIEWS, H, W, gt_seed=None, device="cpu")
    with torch.no_grad():
        gt = batch_render(params_from_numpy(shifted, 3, alive=alive,
                                            device="cpu"), cams,
                          torch.zeros(3), config=RasterConfig(
                              dup_capacity=CAP)).render.numpy()
    cams = cams.replace(gt_image=torch.tensor(gt))
    jcams = j_ring_camera_batch(NVIEWS, H, W, gt_seed=None).replace(
        gt_image=jnp.asarray(gt))
    return jp, jaux, jcams, params, cams


def _vec(rng, like):
    return {g: rng.normal(0, 1, tuple(getattr(like, g).shape)).astype(
        np.float32) for g in PARAM_GROUPS}


def _j(jp, v: dict):
    return jp.replace(**{g: jnp.asarray(x) for g, x in v.items()})


def _t(v: dict):
    return {g: torch.tensor(x) for g, x in v.items()}


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * (np.abs(want).max() + 1e-30),
                               err_msg=what)


def test_lm_params_match_jax():
    assert dataclasses.asdict(LMParams()) == dataclasses.asdict(
        j_config.LMParams())
    assert LMParams().damp_dict() == j_config.LMParams().damp_dict()
    with pytest.raises(NotImplementedError, match="val_pack"):
        LMParams(val_pack=1)


def test_vector_algebra_matches_jax(lm_scene):
    jp, jaux, _, params, _ = lm_scene
    rng = np.random.default_rng(2)
    a, b = _vec(rng, params), _vec(rng, params)
    ja, jb = _j(jp, a), _j(jp, b)
    ta, tb = _t(a), _t(b)
    for kw in ({}, {"mask_xyz": True}, {"mask_opacity": True}):
        assert G.param_group_mask(**kw) == JG.param_group_mask(**kw)
    mask = G.param_group_mask(mask_xyz=True)
    damp = G.default_damp_matrix()
    assert damp == JG.default_damp_matrix()
    alive = np.asarray(jaux.alive)
    pairs = [
        (G.apply_group_mask(ta, mask), JG.apply_group_mask(ja, mask)),
        (G.apply_splat_mask(ta, torch.tensor(alive)),
         JG.apply_splat_mask(ja, jaux.alive.astype(jnp.float32))),
        (G.saxpy(0.7, ta, tb), JG.saxpy(0.7, ja, jb)),
        (G.scale(-1.5, ta), JG.scale(-1.5, ja)),
        (G.add(ta, tb), JG.add(ja, jb))]
    for got, want in pairs:
        for g in PARAM_GROUPS:
            _close(got[g].numpy(), getattr(want, g), 1e-6, g)
    for d in (1.0, 0.3, damp):
        _close(float(G.vdot(ta, tb, d)), float(JG.vdot(ja, jb, d)), 1e-6)
    r = [ResidualState(*(torch.tensor(rng.normal(0, 1, (2, 3, 4, 5))
                                      .astype(np.float32)) for _ in range(2)))
         for _ in range(2)]
    _close(float(res_dot(r[0], r[1])), float(
        (r[0].l1 * r[1].l1).sum() + (r[0].ssim * r[1].ssim).sum()), 1e-6)
    s = res_saxpy(2.0, r[0], res_scale(0.5, r[1]))
    assert torch.allclose(s.ssim, 2.0 * r[0].ssim + 0.5 * r[1].ssim)
    assert float(r[0].loss_scalar) == pytest.approx(
        float(r[0].l1_scalar + r[0].ssim_scalar))


def _jcfg(impl="pallas"):
    return JRasterConfig(dup_capacity=CAP, impl=impl)


@pytest.mark.parametrize("disable_ssim", [True, False])
def test_batch_residuals_match_jax(lm_scene, disable_ssim):
    jp, jaux, jcams, params, cams = lm_scene
    kw = dict(lambda_dssim=0.2, disable_ssim=disable_ssim)
    want = j_batch_residuals(jp, jcams, jnp.zeros(3), config=_jcfg(),
                             alive=jaux.alive, **kw)
    with torch.no_grad():
        got = batch_residuals(params, cams, torch.zeros(3),
                              config=RasterConfig(dup_capacity=CAP), **kw)
    assert (got.ssim is got.l1) == disable_ssim
    if disable_ssim:
        _close(got.l1.numpy(), want.l1, 1e-5)
    else:
        # sqrt(|d| + 1e-6) has slope up to 500 where the render meets its
        # target: compare the squares over their weights, |I - gt| + 1e-6
        # and |1 - SSIM| + 1e-6, at the image bound (2e-6) and twice the
        # SSIM map's (1e-5 on identical images, tests/test_torch_ssim.py;
        # here the two renders' differences enter it too)
        n = 3.0 * H * W
        for f, wt, atol in (("l1", 0.8 / n, 2e-6), ("ssim", 0.2 / n, 2e-5)):
            np.testing.assert_allclose(
                getattr(got, f).numpy() ** 2 / wt,
                np.asarray(getattr(want, f)) ** 2 / wt, atol=atol,
                err_msg=f)
    # with SSIM the loss sums |1 - SSIM|, small where the render meets its
    # target: the map's 1e-5 absolute agreement is ~1e-4 of it
    _close(float(got.loss_scalar), float(want.loss_scalar),
           1e-5 if disable_ssim else 1e-4)


def _dense_problem():
    rng = np.random.default_rng(4)
    A = rng.normal(0, 1, (40, 12)).astype(np.float32)
    b = rng.normal(0, 1, 40).astype(np.float32)
    return A, b


def test_cg_solvers_match_jax():
    """CG on an SPD system and damped CGLS (host and unrolled) on a dense
    least-squares problem; vectors are dicts in parameter space and plain
    arrays in residual space, as in both packages' generic solvers."""
    A, bv = _dense_problem()
    damp = {"w": 0.5}

    def algebra(xp, t):
        def dot(a, b, d=1.0):
            if isinstance(a, dict):
                w = d["w"] if isinstance(d, dict) else d
                return w * xp.sum(a["w"] * b["w"])
            return d * xp.sum(a * b)

        def saxpy(al, x, y):
            if isinstance(x, dict):
                return {"w": al * x["w"] + y["w"]}
            return al * x + y

        def matvec(x):
            return t(A) @ x["w"]

        def matvec_T(r):
            return {"w": t(A).T @ r}

        return dot, saxpy, matvec, matvec_T

    def run(xp, t, solver, mod):
        dot, saxpy, matvec, matvec_T = algebra(xp, t)
        x0 = {"w": t(np.zeros(12, np.float32))}
        dampmul = lambda x: {"w": x["w"] * damp["w"]}   # noqa: E731
        if solver == "cg":
            spd = lambda x: {"w": t(A.T @ A + np.eye(12, dtype=np.float32)  # noqa: E731
                                    ) @ x["w"]}
            return mod.conjugate_gradient(spd, dot, saxpy, None,
                                          {"w": t(A.T @ bv)}, x0,
                                          max_iter=8)
        if solver == "cgls":
            return mod.cgls_damped(matvec, matvec_T, dot, saxpy, t(bv), x0,
                                   damp, dampmul, max_iter=6, restart_iter=2)
        return mod.cgls_damped_unrolled(matvec, matvec_T, dot, saxpy, dampmul,
                                        t(bv), x0, damp, max_iter=6,
                                        restart_iter=2)

    for solver in ("cg", "cgls", "unrolled"):
        want = np.asarray(run(jnp, jnp.asarray, solver, j_cg)["w"])
        got = run(torch, torch.tensor, solver, cg)["w"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=solver)
        assert np.abs(got).max() > 0


VARIANTS = {"default": {}, "ls_subset_views": {"ls_subset_views": 2},
            "ls_val_scale": {"ls_val_scale": 2}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lm_outer_step_matches_jax(lm_scene, variant):
    """One outer step over a 2-view window with 4 val views in chunks of 2.
    The default variant runs the default CG (2 iterations, restart 1,
    divergence check); the staged line searches run a 1-iteration CG
    without the check (what they change is the line search) to keep the
    JAX compile short."""
    jp, jaux, jcams, params, cams = lm_scene
    extra = VARIANTS[variant]
    if variant != "default":
        extra = dict(extra, cg_max_iter=1, check_divergence=False)
    kw = dict(num_images=2, micro_batch=2, num_val_views=4,
              val_view_stride=1, **extra)
    jwin = jax.tree.map(lambda x: x[:2], jcams)
    jval = jax.tree.map(lambda x: x[2:6], jcams)
    jnew, jinfo = j_lm_outer_step(
        jp, jaux.alive, jwin, jval, jnp.zeros(3), rcfg=_jcfg(),
        lm=j_config.LMParams(**kw), active_sh_degree=3, use_exp=False)
    new, info = lm_outer_step(
        params, params.alive, cams.take(slice(0, 2)), cams.take(slice(2, 6)),
        torch.zeros(3), rcfg=RasterConfig(dup_capacity=CAP),
        lm=LMParams(**kw), active_sh_degree=3, use_exp=False)
    assert float(info["best_alpha"]) == float(jinfo["best_alpha"])
    for k in ("start_loss", "val_losses", "best_val_loss"):
        _close(info[k].numpy(), jinfo[k], 1e-4, k)
    if variant == "default":
        assert float(info["best_val_loss"]) == float(info["val_losses"].min())
    for g in PARAM_GROUPS:
        _close(getattr(new, g).detach().numpy(), getattr(jnew, g), 1e-4, g)
        _close(float(info["step_norms"][g]), float(jinfo["step_norms"][g]),
               1e-4, g)
    # mask_xyz (the default): the positions do not move, bit for bit
    assert torch.equal(new.xyz, params.xyz)
    assert torch.equal(new.alive, params.alive)


def test_downscale_val_batch_matches_jax(lm_scene):
    _, _, jcams, _, cams = lm_scene
    want = j_downscale(jcams, 2)
    got = downscale_val_batch(cams, 2)
    assert (got.height, got.width) == (want.height, want.width)
    for f in ("gt_image", "alpha_mask", "invdepth_gt", "depth_mask",
              "heights", "widths"):
        _close(getattr(got, f).numpy(), getattr(want, f), 1e-6, f)


def test_windows_and_val_views_match_jax():
    for seed in (0, 1, 7):
        for n, k in ((6, 2), (50, 5), (3, 5)):
            assert (select_window(n, k, np.random.default_rng(seed))
                    == j_select_window(n, k, np.random.default_rng(seed)))
    for kw in ({}, {"num_val_views": 4, "val_view_stride": 1}):
        for n in (6, 50, 200):
            assert (val_indices(n, LMParams(**kw))
                    == j_val_indices(n, j_config.LMParams(**kw)))


@pytest.mark.parametrize("cull", [True, False])
def test_overflow_probe_matches_jax(lm_scene, cull):
    jp, jaux, jcams, params, cams = lm_scene
    jcfg = JRasterConfig(dup_capacity=4096, live_capacity=2048, cull=cull)
    cfg = RasterConfig(dup_capacity=4096, live_capacity=2048, cull=cull)
    for per_view in (True, False):
        want = j_overflow_probe(jp, jcams, config=jcfg, alive=jaux.alive,
                                per_view=per_view)
        got = overflow_probe(params, cams, config=cfg, per_view=per_view)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
    assert cfg.grow().eff_capacity() == jcfg.grow().eff_capacity()
    assert dataclasses.asdict(cfg.grow(3))["dup_capacity"] == 3 * 4096


def test_lm_phase_grows_a_starved_capacity(lm_scene):
    """``lm_phase`` with a record capacity that fits no render unit grows
    it by doublings until every unit fits (the counts from JAX's probe),
    then steps; a roomy configuration passes through unchanged."""
    jp, jaux, jcams, params, cams = lm_scene
    lm = LMParams(num_images=2, micro_batch=2, num_val_views=4,
                  val_view_stride=1, line_search_steps=1, cg_max_iter=1)
    win = select_window(NVIEWS, 2, np.random.default_rng(0))
    units = [win] + [val_indices(NVIEWS, lm)[i:i + 2] for i in (0, 2)]
    counts = j_overflow_probe(jp, jcams, config=JRasterConfig(),
                              alive=jaux.alive, per_view=True)
    need = max(max(int(np.asarray(counts["n_aabb"])[u].sum()),
                   int(np.asarray(counts["n_live"])[u].sum()))
               for u in units)
    small = RasterConfig(dup_capacity=need // 4, live_capacity=need // 4)
    want = small
    while want.dup_capacity < need:
        want = want.grow()
    new, info, grown = lm_phase(None, params, None, cams, small,
                                torch.zeros(3), lm, 0,
                                np.random.default_rng(0), False, 0.2, 3,
                                verbose=False)
    assert grown == want and grown != small
    assert np.isfinite(float(info["best_val_loss"]))
    assert not torch.equal(new.features_dc, params.features_dc)
    roomy = RasterConfig(dup_capacity=CAP)
    _, _, same = lm_phase(None, params, None, cams, roomy, torch.zeros(3),
                          lm, 1, np.random.default_rng(1), False, 0.2, 3,
                          verbose=False)
    assert same == roomy
