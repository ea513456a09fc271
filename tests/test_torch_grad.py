"""gslm_tpu_torch compositor VJP (ops/rasterize_cuda.py, the module of
kernels A and C) against gslm_tpu's Pallas compositor in interpret mode
(``rasterize_pallas(mode="vjp")``, whose backward is the Pallas kernel C).

On the CPU the port differentiates through the plain versions: kernel A's
closed form forward and ``composite_tiles_bwd_plain`` (autograd of it). Both
packages get the same ``Splats2D`` (the JAX preprocess output, as numpy)
and the same random image and invdepth cotangents.

Scenes: the blob scene of tests/synthetic_scene.py, saturated (opacity
logit 8: alphas clip at 0.99, straight through); a stack of 12 saturated
Gaussians along the view axis, where pixels exit at T < 1e-4 (t_final
freezes, later records get no gradient); a random scene. Tolerances, per
splat field, with scale = max |reference gradient|: blob and stack agree
to atol 1e-5·scale; the random scene uses the knife-edge bound of the
forward parity tests applied to gradients (mean |Δ| < 2e-4·scale, at most
1% of values above 1e-3·scale), since a pair sitting on the 1/255 or
T = 1e-4 gate can flip between the two codegens. ``depth_grad`` runs True
and False.

Kernel C itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py). Here its algorithm, the reverse walk from kernel A's saved
exit state with the suffix accumulator, is mirrored in numpy and held
against the plain version at the same bounds."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.models.gaussians import GaussianParams as JGaussianParams
from gslm_tpu.ops.projection import preprocess as j_preprocess
from gslm_tpu.ops.rasterize_pallas import rasterize_pallas as j_rasterize_pallas
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu_torch.ops.projection import Splats2D
from gslm_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                               composite_tiles_bwd,
                                               composite_tiles_bwd_plain,
                                               composite_tiles_plain,
                                               rasterize_cuda, tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from tests.synthetic_scene import blob_params

CAP = 1 << 12
FIELDS = ("mean2d", "conic", "color", "opacity", "invdepth")
BG = np.array([0.2, 0.5, 0.8], np.float32)


def _stack_params(n=12):
    rng = np.random.default_rng(4)
    xyz = np.c_[rng.uniform(-0.3, 0.3, (n, 2)), np.linspace(-1.5, 1.5, n)]
    return JGaussianParams(
        xyz=jnp.asarray(xyz, jnp.float32),
        features_dc=jnp.asarray(rng.normal(0, 0.5, (n, 1, 3)), jnp.float32),
        features_rest=jnp.zeros((n, 15, 3)),
        scaling=jnp.full((n, 3), math.log(0.5)),
        rotation=jnp.zeros((n, 4)).at[:, 0].set(1.0),
        opacity=jnp.full((n, 1), 8.0),
        exposure=jnp.broadcast_to(jnp.eye(3, 4), (1, 3, 4)), sh_degree=3)


def _scene(kind):
    if kind in ("blob", "stack"):
        params = (blob_params(num_images=1, opacity=8.0) if kind == "blob"
                  else _stack_params())
        h, w, radius = 64, 64, 5.0
    else:
        params, _ = j_random_gaussians(np.random.default_rng(0), n=128)
        h, w, radius = 48, 64, 4.0
    meta = j_make_camera(height=h, width=w, radius=radius)
    js = j_preprocess(params, j_camera_from_meta(meta),
                      active_sh_degree=params.sh_degree)
    return js, h, w


def _to_port(js) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in vars(js).items()}


def _bounded(got, want, kind):
    scale = np.abs(want).max() + 1e-12
    d = np.abs(got - want)
    if kind != "random":
        return d.max() <= 1e-5 * scale
    return d.mean() < 2e-4 * scale and (d > 1e-3 * scale).mean() <= 0.01


@pytest.mark.parametrize("kind,depth_grad", [
    ("blob", True), ("stack", True), ("random", True), ("random", False)])
def test_composite_vjp_matches_pallas(kind, depth_grad):
    js, h, w = _scene(kind)
    rng = np.random.default_rng(1)
    u = rng.normal(0, 1, (3, h, w)).astype(np.float32)
    ui = rng.normal(0, 1, (1, h, w)).astype(np.float32)

    def j_loss(*fields):
        out = j_rasterize_pallas(
            js.replace(**dict(zip(FIELDS, fields))), h, w, jnp.asarray(BG),
            JRasterConfig(dup_capacity=CAP, depth_grad=depth_grad),
            interpret=True, mode="vjp")
        return jnp.sum(out["render"] * u) + jnp.sum(out["invdepth"] * ui)

    want = jax.grad(j_loss, argnums=tuple(range(len(FIELDS))))(
        *[getattr(js, k) for k in FIELDS])

    sp = _to_port(js)
    leaves = [sp[k].requires_grad_(True) for k in FIELDS]
    before = composite_tiles.launches, composite_tiles_bwd.launches
    out = rasterize_cuda(Splats2D(**sp), h, w, torch.tensor(BG),
                         RasterConfig(dup_capacity=CAP, depth_grad=depth_grad))
    loss = ((out["render"] * torch.tensor(u)).sum()
            + (out["invdepth"] * torch.tensor(ui)).sum())
    got = torch.autograd.grad(loss, leaves)
    # CPU tensors take the plain versions: no kernel was launched
    assert (composite_tiles.launches, composite_tiles_bwd.launches) == before
    for k, g, wnt in zip(FIELDS, got, want):
        g, wnt = g.numpy(), np.asarray(wnt)
        assert np.isfinite(g).all(), k
        assert _bounded(g, wnt, kind), (k, np.abs(g - wnt).max())
    if not depth_grad:
        assert float(got[FIELDS.index("invdepth")].abs().max()) == 0.0


def _reverse_walk(rec, starts, counts, ntx, view_rows, gtiles, state,
                  depth_grad):
    """Kernel C's algorithm (csrc/composite_bwd.cu) in float32 numpy, the
    256 pixels of a tile as one vector: walk each tile's records in reverse
    from the largest exit position, recover T_before by subtracting
    log1p(-a) from the saved exit sum, carry S from g_T * T_exit."""
    rec = rec.astype(np.float32)
    drec = np.zeros_like(rec)
    lane = np.arange(256)
    f32 = np.float32
    for t in range(len(counts)):
        px = ((t % ntx) * 16 + lane % 16).astype(f32)
        py = (((t // ntx) % view_rows) * 16 + lane // 16).astype(f32)
        g = gtiles[t].astype(f32)
        g_i = g[3] if depth_grad else np.zeros(256, f32)
        lsum = state[t, 0].astype(f32)
        exit_pos = state[t, 1].astype(np.int64)
        s_acc = g[4] * np.exp(lsum)
        for i in range(int(exit_pos.max()) - 1, -1, -1):
            r = rec[starts[t] + i]
            dx, dy = r[0] - px, r[1] - py
            power = f32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            expp = np.exp(np.minimum(power, f32(0)))
            a_raw = r[5] * expp
            a = np.minimum(a_raw, f32(0.99))
            act = (i < exit_pos) & (power <= 0) & (a >= f32(1 / 255))
            l_before = np.minimum(lsum - np.log1p(-a), f32(0))
            T = np.exp(l_before)
            wgt = a * T
            dw = r[6] * g[0] + r[7] * g[1] + r[8] * g[2] + r[9] * g_i
            da = dw * T - s_acc / (f32(1) - a)
            s_acc = np.where(act, s_acc + dw * wgt, s_acc)
            lsum = np.where(act, l_before, lsum)
            dpow = da * a_raw
            terms = (dpow * -(r[2] * dx + r[3] * dy),
                     dpow * -(r[4] * dy + r[3] * dx),
                     dpow * (f32(-0.5) * dx * dx), dpow * (-dx * dy),
                     dpow * (f32(-0.5) * dy * dy), da * expp,
                     wgt * g[0], wgt * g[1], wgt * g[2], wgt * g_i)
            drec[starts[t] + i] = [np.where(act, v, 0).sum() for v in terms]
    return drec


@pytest.mark.parametrize("kind", ["stack", "random"])
def test_reverse_walk_matches_plain_backward(kind):
    """The reverse walk from the exit state (kernel C's algorithm) against
    autograd of the closed form, on the plain forward's own exit state;
    every row past a tile's exits is exactly zero in both."""
    js, h, w = _scene(kind)
    ntx, nty = -(-w // 16), -(-h // 16)
    records, starts, counts, *_ = tile_records(
        Splats2D(**_to_port(js)), ntx, nty, RasterConfig(dup_capacity=CAP))
    tiles, _ = composite_tiles_plain(records, starts, counts, ntx, nty)
    if kind == "stack":   # the stacked splats freeze pixels: exits taken
        assert int((tiles[:, 6] < counts[:, None]).sum()) > 100
    gt = torch.tensor(np.random.default_rng(2).normal(
        0, 1, (counts.shape[0], 5, 256)).astype(np.float32))
    for depth_grad in (True, False):
        want = composite_tiles_bwd_plain(records, starts, counts, ntx, nty,
                                         gt, depth_grad).numpy()
        got = _reverse_walk(records.numpy(), starts.numpy(), counts.numpy(),
                            ntx, nty, gt.numpy(), tiles[:, 5:].numpy(),
                            depth_grad)
        for f in range(10):
            assert _bounded(got[:, f], want[:, f], kind), (
                f, np.abs(got[:, f] - want[:, f]).max())
        # the CPU wrapper is the plain version, state or no state
        np.testing.assert_array_equal(
            composite_tiles_bwd(records, starts, counts, ntx, nty, gt,
                                tiles[:, 5:], depth_grad).numpy(), want)


def test_plain_backward_chunking_changes_only_rounding():
    """The plain backward recomputes the forward chunk by chunk of tiles,
    each chunk over its own record range: one tile per chunk agrees with
    the default chunking to rounding (atol 1e-6·scale; autograd's sums run
    over other padded shapes, so not bit for bit)."""
    js, h, w = _scene("random")
    records, starts, counts, *_ = tile_records(
        Splats2D(**_to_port(js)), 4, 3, RasterConfig(dup_capacity=CAP))
    gt = torch.tensor(np.random.default_rng(3).normal(
        0, 1, (counts.shape[0], 5, 256)).astype(np.float32))
    a = composite_tiles_bwd_plain(records, starts, counts, 4, 3, gt)
    b = composite_tiles_bwd_plain(records, starts, counts, 4, 3, gt,
                                  max_elems=1)
    scale = float(a.abs().max())
    assert scale > 0
    assert float((a - b).abs().max()) <= 1e-6 * scale
