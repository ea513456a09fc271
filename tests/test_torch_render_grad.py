"""Gradients of gslm_tpu_torch ``render`` / ``batch_render`` (preprocess,
the compositor VJP, exposure) against ``jax.grad`` through gslm_tpu's
renderer with its Pallas VJP compositor in interpret mode.

Same numpy scene in both packages: 200 random Gaussians padded to a
capacity of 224 (24 dead slots), three of them moved behind the first
camera, to its near plane and far off-screen, and per-view exposures.
Loss: mean |render - gt| + 0.1 mean(invdepth), with the trained exposure
applied. All seven parameter groups and the ``mean2d_offset`` cotangent
(the densification carrier) agree per group to atol 1e-5·max|g|, as in
tests/test_pallas_grad.py. Gaussians that no view sees (culled, dead,
off-screen) get finite gradients that are exactly zero in both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.renderer import batch_render as j_batch_render
from gslm_tpu.renderer import render as j_render
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.renderer import batch_render, render
from gslm_tpu_torch.utils.synthetic import ring_camera_batch
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W, B, N, CAPACITY = 48, 64, 2, 200, 224
BG = np.array([0.2, 0.5, 0.8], np.float32)
# behind camera 0 (view z -2), inside its near plane (z 0.1), off-screen
MOVED = np.array([[0.0, 0.0, -6.0], [0.0, 0.0, -3.9], [0.0, 10.0, 0.0]],
                 np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    jp, jaux = j_random_gaussians(rng, n=N, capacity=CAPACITY, num_images=B,
                                  spread=1.5)
    xyz = np.asarray(jp.xyz).copy()
    xyz[:3] = MOVED
    exposure = (np.eye(3, 4)[None] + rng.normal(0, 0.1, (B, 3, 4))
                ).astype(np.float32)
    jp = jp.replace(xyz=jnp.asarray(xyz), exposure=jnp.asarray(exposure))
    groups = {g: np.asarray(getattr(jp, g)) for g in PARAM_GROUPS}
    tp = params_from_numpy(groups, 3, alive=np.asarray(jaux.alive),
                           device="cpu")
    return jp, jaux, tp


@pytest.mark.parametrize("batched", [False, True])
def test_render_grads_match_jax(scene, batched):
    jp, jaux, tp = scene
    jcams = j_ring_camera_batch(B, H, W)
    gt = np.asarray(jcams.gt_image) if batched else np.asarray(
        jcams.gt_image)[0]
    cfg = RasterConfig(dup_capacity=1 << 12)
    jcfg = JRasterConfig(dup_capacity=1 << 12)

    def j_loss(p, m2d):
        kw = dict(config=jcfg, impl="pallas", use_trained_exp=True,
                  alive=jaux.alive, mean2d_offset=m2d)
        if batched:
            out = j_batch_render(p, jcams, jnp.asarray(BG), **kw)
        else:
            out = j_render(p, jcams.view(0), jnp.asarray(BG), **kw)
        return (jnp.mean(jnp.abs(out.render - gt))
                + 0.1 * jnp.mean(out.invdepth))

    jg, jm2d = jax.grad(j_loss, argnums=(0, 1))(
        jp, jnp.zeros((CAPACITY, 2), jnp.float32))

    cams = ring_camera_batch(B, H, W, device="cpu")
    m2d = torch.zeros(CAPACITY, 2, requires_grad=True)
    kw = dict(config=cfg, use_trained_exp=True, mean2d_offset=m2d)
    if batched:
        out = batch_render(tp, cams, torch.tensor(BG), **kw)
    else:
        out = render(tp, cams.view(0), torch.tensor(BG), **kw)
    loss = (torch.mean(torch.abs(out.render - torch.tensor(gt)))
            + 0.1 * torch.mean(out.invdepth))
    leaves = [getattr(tp, g) for g in PARAM_GROUPS] + [m2d]
    got = torch.autograd.grad(loss, leaves)

    unseen = np.asarray(out.radii).reshape(-1, CAPACITY).max(axis=0) == 0
    assert unseen[N:].all() and unseen[2]      # dead slots, off-screen
    if not batched:
        assert unseen[:2].all()                # behind, near plane
    for name, g, want in zip(list(PARAM_GROUPS) + ["mean2d_offset"], got,
                             [getattr(jg, k) for k in PARAM_GROUPS] + [jm2d]):
        g, want = g.numpy(), np.asarray(want)
        assert np.isfinite(g).all(), name
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(g, want, atol=1e-5 * scale, err_msg=name)
        if name != "exposure":
            assert not want[unseen].any() and not g[unseen].any(), name
