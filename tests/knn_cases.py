"""Point clouds made to break a grid search for the 3 nearest neighbours
(kernel F, gslm_tpu_torch/csrc/knn.cu), shared by the CPU tests of its
numpy mirror (tests/test_torch_native.py) and the card tests
(tests/test_torch_cuda.py). Imports no JAX."""

import numpy as np

from gslm_tpu_torch.utils.synthetic import clustered_cloud


def lattice(shape, step, offset) -> np.ndarray:
    g = np.stack(np.meshgrid(*[np.arange(k) for k in shape], indexing="ij"),
                 -1).reshape(-1, 3)
    return (g * step + offset).astype(np.float32)


def hard_clouds() -> dict:
    """name → (P, 3) float32. The lattices of shape (3, 5, 15) and
    (4, 4, 4) get a grid whose cell is the lattice step (``build_grid``:
    one cell per step along each axis), so every point lies on a cell
    face, exactly at step 0.5 and rounded to either side of it at 0.1 and
    0.3 about 1000 and -7."""
    rng = np.random.default_rng(11)
    u = rng.uniform(-1.0, 1.0, (400, 2))
    line = rng.uniform(-1.0, 1.0, (300, 1))
    clouds = {
        "faces_exact": lattice((3, 5, 15), 0.5, 0.0),
        "faces_rounded": lattice((3, 5, 15), 0.1, 1000.0),
        "faces_cube": lattice((4, 4, 4), 0.3, -7.0),
        "lattice_ties": lattice((12, 12, 12), 0.1, 0.0),
        "coplanar": np.c_[u, np.full(400, 0.3)],
        "coplanar_tilted": np.c_[u, u @ np.array([0.3, -0.7])],
        "collinear": np.c_[line, np.zeros((300, 2))],
        "collinear_diagonal": np.repeat(line, 3, axis=1),
        "thin_slab": np.c_[u, rng.uniform(0.0, 1e-7, 400)],
        "identical": np.ones((40, 3)),
        "duplicates": np.repeat(rng.normal(size=(80, 3)), 3, axis=0),
        "two_stacks": np.r_[np.zeros((20, 3)), np.ones((20, 3))],
        "far_outliers": np.r_[rng.uniform(0.0, 1.0, (400, 3)),
                              [[1e6, 0, 0], [-1e6, 5, 5]]],
        "clustered": clustered_cloud(rng, 1200),
        "normal": rng.normal(0.0, 1.0, (1000, 3)) + 5.0,
        **{f"p{n}": rng.normal(size=(n, 3)) for n in range(1, 6)},
    }
    return {k: np.asarray(v, np.float32) for k, v in clouds.items()}
