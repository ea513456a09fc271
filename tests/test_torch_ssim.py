"""gslm_tpu_torch SSIM path (ops/blur_cuda.py, kernel B's module, and
ops/ssim.py) against gslm_tpu.

Kernel B's plain version against the JAX Pallas blur in interpret mode:
atol 1e-6 (same taps, same tap order, f32 rounding only), for k in {1, 3,
5, 11, 15} on four shapes up to (2, 1080, 1920). SSIM map against
JAX's CPU SSIM (a dense conv at HIGH precision there): atol 1e-5; PSNR
1e-4 dB. Gradients of the SSIM map (through ``blur``, whose VJP is the
reversed-tap blur) against ``jax.grad`` of JAX's map: atol 1e-5. The
blur's VJP on the CPU is the plain reversed-tap blur, bit for bit. The card
tests (tests/test_torch_cuda.py) hold kernel B to the plain version bit for
bit, forward, VJP and JVP, for k in {1, 3, 5, 11, 15} on the shapes the
plain version is checked on here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gslm_tpu.ops.blur_pallas import blur_same as j_blur_same
from gslm_tpu.ops.ssim import ssim as j_ssim
from gslm_tpu.ops.ssim import ssim_map as j_ssim_map
from gslm_tpu.utils.image import psnr as j_psnr
from gslm_tpu_torch.ops.blur_cuda import blur, blur_plain, blur_same
from gslm_tpu_torch.ops.ssim import gaussian_taps, ssim, ssim_map
from gslm_tpu_torch.utils.image import mse, psnr
from torch_threads import one_thread  # noqa: F401 (autouse)


def _images(seed, shape=(3, 40, 72)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(3, 40, 72), (15, 67, 133), (1, 5, 3),
                                   (2, 1080, 1920)])
@pytest.mark.parametrize("k", [1, 3, 5, 11, 15])
def test_blur_plain_matches_pallas_blur(k, shape):
    """Every tap count kernel B is tested with on the card, on its shapes
    (a plane smaller than the halo among them)."""
    x, _ = _images(0, shape)
    taps = gaussian_taps(k)
    want = np.asarray(j_blur_same(jnp.asarray(x), taps, interpret=True))
    got = blur_same(torch.tensor(x), taps)          # CPU → plain version
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(blur_plain(torch.tensor(x), taps).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("batched", [False, True])
def test_ssim_psnr_match_jax(batched):
    a, b = _images(1)
    if batched:
        a, b = a[None], b[None]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.tensor(a), torch.tensor(b)
    np.testing.assert_allclose(ssim_map(ta, tb).numpy(),
                               np.asarray(j_ssim_map(ja, jb)), atol=1e-5)
    assert abs(float(ssim(ta, tb)) - float(j_ssim(ja, jb))) < 1e-5
    np.testing.assert_allclose(psnr(ta, tb).numpy(),
                               np.asarray(j_psnr(ja, jb)), atol=1e-4)
    assert float(mse(ta, tb).mean()) == pytest.approx(
        float(np.mean((a - b) ** 2)), rel=1e-5)



def test_blur_vjp_is_reversed_tap_blur():
    """Asymmetric taps, so a forward-tap "VJP" would fail."""
    x, g = _images(2)
    taps = np.array([0.1, 0.5, 0.2, 0.15, 0.05], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    before = blur_same.launches, blur_same.vjp_launches
    (got,) = torch.autograd.grad(blur(xt, taps), xt, torch.tensor(g))
    assert (blur_same.launches, blur_same.vjp_launches) == before  # CPU
    np.testing.assert_array_equal(
        got.numpy(), blur_plain(torch.tensor(g), taps[::-1]).numpy())
    _, vjp = jax.vjp(lambda v: j_blur_same(v, taps, interpret=True),
                     jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_ssim_map_grads_match_jax(batched):
    a, b = _images(3)
    if batched:
        a, b = a[None], b[None]
    w = np.random.default_rng(4).normal(0, 1, a.shape).astype(np.float32)
    ga, gb = jax.grad(lambda x, y: jnp.sum(j_ssim_map(x, y) * w),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    got = torch.autograd.grad((ssim_map(ta, tb) * torch.tensor(w)).sum(),
                              (ta, tb))
    for g, want in zip(got, (ga, gb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5)
