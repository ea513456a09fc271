"""gslm_tpu_torch forward mode (J·v): ops/rasterize_cuda.py, the module of
kernel E, and the blur's JVP, against gslm_tpu.

- J·v of ``batch_render`` along a tangent of each parameter group in
  turn, against ``jax.jvp`` of JAX's ``batch_render`` with
  ``impl="pallas_jvp"`` (the Pallas kernel E in interpret mode): atol
  1e-5·max|J·v| (tests/test_pallas_grad.py:52-67). The port runs the plain
  version of kernel E (forward AD of the closed-form composite) on the CPU;
  no kernel launches.
- Kernel E's algorithm, the per-pixel front-to-back walk carrying the
  tangent of the log-transmittance, mirrored in numpy and held against
  forward AD of the closed form (``composite_tiles_jvp_plain``) on a stack
  of saturated splats where pixels exit (blob-like: atol 1e-5·max) and on
  a random scene (the knife-edge bound of tests/test_torch_grad.py). The
  plain version's primal equals ``composite_tiles_plain`` bit for bit.
- The adjoint ⟨J·v, u⟩ = ⟨v, Jᵀ·u⟩ of the LM operators to 1e-4 relative,
  with the plain residual and with the SSIM residuals (J·v then runs the
  blur's JVP), as tests/test_operators.py holds JAX's.
- ``LMOperators`` over a micro-batched window (``chunked_residual_fn``)
  against JAX's, on the LM scene of tests/test_torch_lm.py: the residual
  to 5e-6 (the bound of JAX's own chunked residual), Jᵀ·u per group to
  1e-5·max, J·v along six groups at once to 2e-5·max (six tangents of
  either sign summed per pixel).
- Forward AD of the blur is the blur of the tangent, bit for bit.
- Records that carry a tangent and record autograd (double mode) raise.

Kernel E itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.renderer import batch_render as j_batch_render
from gslm_tpu.solver.operators import LMOperators as JLMOperators
from gslm_tpu.solver.operators import chunked_residual_fn as j_chunked
from gslm_tpu.solver.residuals import batch_residuals as j_batch_residuals
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.models import gaussians as G
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops.blur_cuda import blur, blur_plain
from gslm_tpu_torch.ops.projection import Splats2D
from gslm_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                               composite_tiles_jvp,
                                               composite_tiles_jvp_plain,
                                               composite_tiles_plain,
                                               tile_records)
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.ops.ssim import gaussian_taps
from gslm_tpu_torch.renderer import batch_render
from gslm_tpu_torch.solver.operators import LMOperators, chunked_residual_fn
from gslm_tpu_torch.solver.residuals import (ResidualState, batch_residuals,
                                             res_dot)
from gslm_tpu_torch.utils.synthetic import ring_camera_batch
from tests.test_torch_grad import CAP, _bounded, _scene, _to_port
from tests.test_torch_lm import N, _close, _j, _jcfg, _t, _vec
from tests.test_torch_lm import lm_scene  # noqa: F401 (a fixture)

H, W, VIEWS = 48, 64, 2


@pytest.fixture(scope="module")
def jvp_scene():
    """~200 Gaussians in both packages, 2 views of 48x64, and JAX's J·v
    of the batched render (one compile for every group's tangent)."""
    jp, jaux = j_random_gaussians(np.random.default_rng(0), n=200,
                                  num_images=VIEWS, spread=1.0)
    groups = {g: np.asarray(getattr(jp, g)) for g in PARAM_GROUPS}
    params = params_from_numpy(groups, 3, device="cpu")
    jcams = j_ring_camera_batch(VIEWS, H, W)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jcfg = JRasterConfig(dup_capacity=CAP, impl="pallas_jvp")

    @jax.jit
    def j_jv(p, v):
        def img(q):
            return j_batch_render(q, jcams, jnp.asarray(bg), config=jcfg,
                                  use_trained_exp=True).render
        return jax.jvp(img, (p,), (v,))[1]

    return jp, j_jv, params, ring_camera_batch(VIEWS, H, W, device="cpu"), bg


def _tangent(params, group, seed):
    rng = np.random.default_rng(seed)
    return {g: np.asarray(rng.normal(0, 1, tuple(getattr(params, g).shape))
                          if g == group else
                          np.zeros(tuple(getattr(params, g).shape)),
                          np.float32)
            for g in PARAM_GROUPS}


@pytest.mark.parametrize("group", PARAM_GROUPS)
def test_batch_render_jvp_matches_pallas_jvp(jvp_scene, group):
    jp, j_jv, params, cams, bg = jvp_scene
    v = _tangent(params, group, PARAM_GROUPS.index(group))
    want = np.asarray(j_jv(jp, jp.replace(**{g: jnp.asarray(x)
                                             for g, x in v.items()})))
    before = composite_tiles.launches, composite_tiles_jvp.launches
    with torch.no_grad(), fwAD.dual_level():
        duals = {g: fwAD.make_dual(x, torch.tensor(v[g]))
                 for g, x in params.groups().items()}
        out = batch_render(G.with_groups(params, duals), cams,
                           torch.tensor(bg), config=RasterConfig(
                               dup_capacity=CAP), use_trained_exp=True)
        got = fwAD.unpack_dual(out.render).tangent.numpy()
    # CPU tensors take the plain version: no kernel was launched
    assert (composite_tiles.launches, composite_tiles_jvp.launches) == before
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, err_msg=group)


def _forward_walk(rec, tng, starts, counts, ntx, view_rows):
    """Kernel E's algorithm (csrc/composite_jvp.cu) in float32 numpy, the
    256 pixels of a tile as one vector: walk the tile's records front to
    back, carry the tangent of the log-transmittance sum, freeze t_final
    and its tangent at the first record with T_after < 1e-4."""
    f32 = np.float32
    rec, tng = rec.astype(f32), tng.astype(f32)
    ntiles = len(counts)
    out = np.zeros((ntiles, 5, 256), f32)
    out_dot = np.zeros((ntiles, 5, 256), f32)
    lane = np.arange(256)
    for t in range(ntiles):
        px = ((t % ntx) * 16 + lane % 16).astype(f32)
        py = (((t // ntx) % view_rows) * 16 + lane // 16).astype(f32)
        lsum = np.zeros(256, f32)
        T = np.ones(256, f32)
        lsum_dot = np.zeros(256, f32)
        t_final, t_final_dot = np.ones(256, f32), np.zeros(256, f32)
        acc = np.zeros((4, 256), f32)
        acc_dot = np.zeros((4, 256), f32)
        done = np.zeros(256, bool)
        for i in range(int(counts[t])):
            r, d = rec[starts[t] + i], tng[starts[t] + i]
            dx, dy = r[0] - px, r[1] - py
            power = f32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            expp = np.exp(np.minimum(power, f32(0)))
            a_raw = r[5] * expp
            a = np.minimum(a_raw, f32(0.99))
            con = ~done & (power <= 0) & (a >= f32(1 / 255))
            l_after = lsum + np.log1p(-a)
            t_after = np.exp(l_after)
            T_dot = T * lsum_dot
            ex = con & (t_after < f32(1e-4))
            t_final = np.where(ex, T, t_final)
            t_final_dot = np.where(ex, T_dot, t_final_dot)
            done |= ex
            ok = con & ~ex
            pow_dot = (-(r[2] * dx + r[3] * dy) * d[0]
                       - (r[4] * dy + r[3] * dx) * d[1]
                       - f32(0.5) * dx * dx * d[2] - dx * dy * d[3]
                       - f32(0.5) * dy * dy * d[4])
            a_dot = d[5] * expp + a_raw * pow_dot
            w = a * T
            w_dot = a_dot * T + a * T_dot
            for c in range(4):
                acc[c] += np.where(ok, w * r[6 + c], 0)
                acc_dot[c] += np.where(ok, w_dot * r[6 + c] + w * d[6 + c], 0)
            lsum = np.where(ok, l_after, lsum)
            T = np.where(ok, t_after, T)
            lsum_dot = np.where(ok, lsum_dot - a_dot / (f32(1) - a), lsum_dot)
        t_final = np.where(done, t_final, T)
        t_final_dot = np.where(done, t_final_dot, T * lsum_dot)
        out[t, :4], out[t, 4] = acc, t_final
        out_dot[t, :4], out_dot[t, 4] = acc_dot, t_final_dot
    return out, out_dot


@pytest.mark.parametrize("kind", ["stack", "random"])
def test_forward_walk_matches_plain_jvp(kind):
    """Kernel E's walk against forward AD of the closed form; the plain
    version's primal is ``composite_tiles_plain``'s, bit for bit."""
    js, h, w = _scene(kind)
    ntx, nty = -(-w // 16), -(-h // 16)
    records, starts, counts, *_ = tile_records(
        Splats2D(**_to_port(js)), ntx, nty, RasterConfig(dup_capacity=CAP))
    tng = torch.tensor(np.random.default_rng(5).normal(
        0, 1, tuple(records.shape)).astype(np.float32))
    tiles, tiles_dot = composite_tiles_jvp_plain(records, tng, starts, counts,
                                                 ntx, nty)
    fwd, _ = composite_tiles_plain(records, starts, counts, ntx, nty)
    assert torch.equal(tiles, fwd)
    if kind == "stack":   # the stacked splats freeze pixels: exits taken
        assert int((tiles[:, 6] < counts[:, None]).sum()) > 100
    # the CPU wrapper is the plain version
    w_tiles, w_dot = composite_tiles_jvp(records, tng, starts, counts, ntx,
                                         nty)
    assert torch.equal(w_tiles, tiles) and torch.equal(w_dot, tiles_dot)
    got, got_dot = _forward_walk(records.numpy(), tng.numpy(),
                                 starts.numpy(), counts.numpy(), ntx, nty)
    for row in range(5):
        assert _bounded(got[:, row], tiles[:, row].numpy(), kind), row
        assert _bounded(got_dot[:, row], tiles_dot[:, row].numpy(), kind), (
            row, np.abs(got_dot[:, row] - tiles_dot[:, row].numpy()).max())


@pytest.mark.parametrize("disable_ssim", [True, False])
def test_adjoint_consistency(disable_ssim):
    """⟨J·v, u⟩ = ⟨v, Jᵀ·u⟩ to 1e-4 relative (tests/test_operators.py)."""
    from gslm_tpu_torch.utils.synthetic import random_gaussians
    params = random_gaussians(np.random.default_rng(0), n=200,
                              num_images=VIEWS, spread=1.0, device="cpu")
    cams = ring_camera_batch(VIEWS, H, W, device="cpu")
    ops = LMOperators(lambda p: batch_residuals(
        p, cams, torch.zeros(3), config=RasterConfig(dup_capacity=CAP),
        disable_ssim=disable_ssim), params)
    rng = np.random.default_rng(11)
    v = {g: torch.tensor(rng.normal(0, 1, tuple(x.shape)).astype(np.float32))
         for g, x in params.groups().items()}
    u = ResidualState(*(torch.tensor(rng.normal(
        0, 1, tuple(ops.residual.l1.shape)).astype(np.float32))
        for _ in range(2)))
    lhs = float(res_dot(ops.matvec(v), u))
    jtu = ops.matvec_T(u)
    rhs = float(G.vdot(v, jtu))
    assert abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-8) < 1e-4, (lhs, rhs)
    assert float(ops.loss_scalar) > 0.0
    # without the retained linearization every Jᵀ·u re-renders: same bits
    fresh = LMOperators(ops.residual_fn, params, reuse_linearization=False)
    again = fresh.matvec_T(u)
    assert all(torch.equal(again[g], jtu[g]) for g in PARAM_GROUPS)


def test_dual_records_that_record_autograd_raise():
    from gslm_tpu_torch.ops.rasterize_cuda import composite_image_rows
    js, h, w = _scene("random")
    records, starts, counts, *_ = tile_records(
        Splats2D(**_to_port(js)), 4, 3, RasterConfig(dup_capacity=CAP))
    leaf = records.detach().requires_grad_(True)
    with fwAD.dual_level():
        dual = fwAD.make_dual(leaf, torch.ones_like(records))
        with pytest.raises(NotImplementedError, match="double-mode"):
            composite_image_rows(dual, starts, counts, 4, 3, True)
        with torch.no_grad():   # forward mode alone goes through
            rows = composite_image_rows(dual, starts, counts, 4, 3, True)
            assert fwAD.unpack_dual(rows).tangent is not None


def test_blur_jvp_is_the_blur_of_the_tangent():
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.uniform(0, 1, (2, 15, 20, 33)).astype(np.float32))
    v = torch.tensor(rng.normal(0, 1, (2, 15, 20, 33)).astype(np.float32))
    taps = gaussian_taps()
    with fwAD.dual_level():
        y = blur(fwAD.make_dual(x, v), taps)
        primal, tangent = fwAD.unpack_dual(y)
    assert torch.equal(primal, blur_plain(x, taps))
    assert torch.equal(tangent, blur_plain(v, taps))


def test_lm_operators_match_jax(lm_scene):
    """J·v, Jᵀ·u and the loss of the LM operators, with the xyz group and
    the alive masks, over a window of 4 views micro-batched in chunks of 2
    (the last view a zero-weight pad), against JAX's (Jᵀ·u through the
    Pallas VJP, J·v through the ``pallas_jvp`` twin)."""
    jp, jaux, jcams, params, cams = lm_scene
    idx = [0, 1, 2, 0]
    w = np.array([1, 1, 1, 0], np.float32)
    jwin = jax.tree.map(lambda x: x[jnp.asarray(idx)], jcams)
    win = cams.take(idx)
    mask = G.param_group_mask(mask_xyz=True)
    rng = np.random.default_rng(3)
    v = _vec(rng, params)
    u = [rng.normal(0, 1, (4, 3, H, W)).astype(np.float32) for _ in range(2)]

    def j_res(cfg):
        return j_chunked(lambda p, c: j_batch_residuals(
            p, c, jnp.zeros(3), config=cfg, disable_ssim=True,
            alive=jaux.alive), jwin, 2, view_valid=jnp.asarray(w))

    @jax.jit
    def j_ops(p, v, u0, u1):
        ops = JLMOperators(j_res(_jcfg()), p, group_mask=mask,
                           alive=jaux.alive,
                           residual_fn_jvp=j_res(_jcfg("pallas_jvp")))
        return (ops.loss_scalar, ops.residual, ops.matvec(v),
                ops.matvec_T(ops.residual.replace(l1=u0, ssim=u1)))

    j_loss, j_r, j_jv, j_jtu = j_ops(jp, _j(jp, v), *map(jnp.asarray, u))
    res = chunked_residual_fn(lambda p, c: batch_residuals(
        p, c, torch.zeros(3), config=RasterConfig(dup_capacity=CAP),
        disable_ssim=True, alive=params.alive), win, 2,
        view_valid=torch.tensor(w))
    ops = LMOperators(res, params, group_mask=mask, alive=params.alive)
    jv = ops.matvec(_t(v))
    jtu = ops.matvec_T(ResidualState(*map(torch.tensor, u)))
    _close(float(ops.loss_scalar), float(j_loss), 1e-5)
    # JAX's lax.map over the chunks re-fuses the render: its own chunked
    # residual holds to 5e-6 (tests/test_operators.py:136-140)
    np.testing.assert_allclose(ops.residual.l1.numpy(), np.asarray(j_r.l1),
                               atol=5e-6)
    assert float(ops.residual.l1[3].abs().max()) == 0.0      # the pad
    for f in ("l1", "ssim"):
        # six groups' tangents summed per pixel, of either sign: 2e-5·max
        _close(getattr(jv, f).numpy(), getattr(j_jv, f), 2e-5, f)
    for g in PARAM_GROUPS:
        _close(jtu[g].numpy(), getattr(j_jtu, g), 1e-5, g)
    assert float(jtu["xyz"].abs().max()) == 0.0
    assert float(jtu["opacity"][N:].abs().max()) == 0.0      # dead slots
    # a second Jᵀ·u reuses the retained linearization: the same bits
    again = ops.matvec_T(ResidualState(*map(torch.tensor, u)))
    assert all(torch.equal(again[g], jtu[g]) for g in PARAM_GROUPS)
