"""Adversarial records for kernel A's per-record patch mask
(csrc/composite_fwd.cu; plain version ``rasterize_cuda.patch_masks``), used
by tests/test_torch_fwd_patch.py on the CPU and tests/test_torch_cuda.py on
the card. Imports neither JAX nor gslm_tpu.

Records are (N, 10) float32 rows [mean x, mean y, c0, c1, c2, opacity, r, g,
b, invdepth] placed around a tile whose pixel origin is (0, 0), pixel
coordinates without +0.5, as the compositor sees them."""

import numpy as np

# the pixel rows and columns where two of a tile's 8x4 patches (or two
# tiles) meet
BORDERS_X = np.array([-1, 0, 7, 8, 15, 16])
BORDERS_Y = np.array([-1, 0, 3, 4, 7, 8, 11, 12, 15, 16])
KINDS = ("threshold opacity", "edge on a patch border", "anisotropic",
         "not positive definite", "non-finite", "generic")


def _conics(cov_eig, angle):
    """(n, 3) conics (c0, c1, c2) of 2D covariances with eigenvalues
    ``cov_eig`` (n, 2) rotated by ``angle`` (n,), in float64."""
    c, s = np.cos(angle), np.sin(angle)
    l0, l1 = 1.0 / cov_eig[:, 0], 1.0 / cov_eig[:, 1]
    return np.stack([l0 * c * c + l1 * s * s, (l0 - l1) * c * s,
                     l0 * s * s + l1 * c * c], axis=1)


def _edge_means(rng, conic, opacity, n):
    """Means that put the alpha = 1/255 ellipse of each record through a
    pixel on a patch border, to within a relative 1e-6 of its radius."""
    on_x = rng.random(n) < 0.5
    px = np.where(on_x, rng.choice(BORDERS_X, n), rng.integers(-1, 17, n))
    py = np.where(on_x, rng.integers(-1, 17, n), rng.choice(BORDERS_Y, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    v = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    q_v = (conic[:, 0] * v[:, 0] ** 2 + 2 * conic[:, 1] * v[:, 0] * v[:, 1]
           + conic[:, 2] * v[:, 1] ** 2)
    s2 = 2 * np.log(255 * opacity)
    r = np.sqrt(s2 / q_v) * (1 + rng.uniform(-1e-6, 1e-6, n))
    return np.stack([px, py], axis=1) + v * r[:, None]


def adversarial_records(rng: np.random.Generator, n: int = 2000):
    """(6 n, 10) float32 records, ``n`` of each kind in ``KINDS`` order:
    opacities within 1e-6 of 1/255 with means on and near pixels; the
    ellipse's edge through a pixel on a patch border; strong anisotropy
    (covariance eigenvalues 0.3 and up to 1e7, any angle) with the long
    axis's end near the tile; conics that are not positive definite; NaN
    and inf fields; generic records."""
    rows = []
    # 1. opacity within 1e-6 of the 1/255 gate, means on or near pixels
    conic = _conics(rng.uniform(0.3, 30.0, (n, 2)), rng.uniform(0, np.pi, n))
    opacity = 1 / 255 + rng.uniform(-1e-6, 1e-6, n)
    mean = (rng.integers(-2, 18, (n, 2))
            + rng.uniform(-1e-3, 1e-3, (n, 2)) * (rng.random((n, 1)) < 0.7))
    rows.append((mean, conic, opacity))
    # 2. the edge of the alpha >= 1/255 region through a patch-border pixel
    conic = _conics(rng.uniform(0.3, 100.0, (n, 2)), rng.uniform(0, np.pi, n))
    opacity = rng.uniform(0.005, 1.0, n)
    rows.append((_edge_means(rng, conic, opacity, n), conic, opacity))
    # 3. strong anisotropy: covariance eigenvalues 0.3 and 10^(3..7), the
    # edge along the long axis near the tile
    long = 10.0 ** rng.uniform(3, 7, n)
    angle = np.where(rng.random(n) < 0.3, np.pi / 4, rng.uniform(0, np.pi, n))
    conic = _conics(np.stack([np.full(n, 0.3), long], axis=1), angle)
    opacity = rng.uniform(0.01, 1.0, n)
    rows.append((_edge_means(rng, conic, opacity, n), conic, opacity))
    # 4. not positive definite: c0 <= 0, c2 <= 0 or c0 c2 <= c1^2
    c0 = rng.uniform(-1.0, 1.0, n)
    c2 = rng.uniform(-1.0, 1.0, n)
    c1 = np.sqrt(np.abs(c0 * c2)) * rng.uniform(1.0, 2.0, n) * rng.choice(
        [-1, 1], n)
    rows.append((rng.uniform(-8, 24, (n, 2)), np.stack([c0, c1, c2], axis=1),
                 rng.uniform(0.0, 1.0, n)))
    # 5. NaN and inf in one of the six hot fields (or the opacity -inf)
    conic = _conics(rng.uniform(0.3, 30.0, (n, 2)), rng.uniform(0, np.pi, n))
    hot = np.concatenate([rng.uniform(-8, 24, (n, 2)), conic,
                          rng.uniform(0.01, 1.0, (n, 1))], axis=1)
    bad = rng.choice([np.nan, np.inf, -np.inf], n)
    hot[np.arange(n), rng.integers(0, 6, n)] = bad
    rows.append((hot[:, :2], hot[:, 2:5], hot[:, 5]))
    # 6. generic: covariance eigenvalues 0.3 to 1000, opacities to 1.5
    conic = _conics(10.0 ** rng.uniform(np.log10(0.3), 3, (n, 2)),
                    rng.uniform(0, np.pi, n))
    rows.append((rng.uniform(-40, 56, (n, 2)), conic,
                 rng.uniform(0.001, 1.5, n)))
    rec = np.concatenate([np.concatenate([m, c, o[:, None]], axis=1)
                          for m, c, o in rows])
    rgb_d = rng.uniform(0.0, 1.0, (rec.shape[0], 4))
    with np.errstate(invalid="ignore", over="ignore"):
        return np.concatenate([rec, rgb_d], axis=1).astype(np.float32)


def pair_contributes(rec: np.ndarray, px: np.ndarray, py: np.ndarray,
                     fused: bool = False) -> np.ndarray:
    """(N, P) bool: record i contributes at pixel j under kernel A's pair
    arithmetic in float32 (power <= 0, a = fminf(o expf(power), 0.99) >=
    1/255). ``fused``: the power rounded once from float64, as an evaluation
    with every product fused into an FMA comes closest to."""
    f32 = np.float32
    r = rec[:, :, None]
    with np.errstate(invalid="ignore", over="ignore"):
        dx, dy = r[:, 0] - px[None], r[:, 1] - py[None]
        if fused:
            d64 = [x.astype(np.float64) for x in (r[:, 2], r[:, 3], r[:, 4],
                                                 dx, dy)]
            power = (-0.5 * (d64[0] * d64[3] * d64[3] + d64[2] * d64[4]
                             * d64[4]) - d64[1] * d64[3] * d64[4]).astype(f32)
        else:
            power = (f32(-0.5) * (r[:, 2] * dx * dx + r[:, 4] * dy * dy)
                     - r[:, 3] * dx * dy)
        gate = power <= 0
        a = np.fmin(r[:, 5] * np.exp(np.where(gate, power, f32(0))), f32(0.99))
    return gate & (a >= f32(1 / 255))
