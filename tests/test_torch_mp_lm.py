"""gslm_tpu_torch.parallel's model-parallel LM outer step
(``make_mp_lm_step``, gathered and routed, with a padded window, and JAX's
GSPMD name ``make_sharded_lm_step``) against the port's single-process
``lm_outer_step`` and gslm_tpu's ``make_mp_lm_step``.

The port's ranks are 4 gloo processes on the CPU, a (2, 2) mesh
(``tests/torch_ranks.py``, spawned once for the module): the residuals
are banded, CGLS runs over the sharded operators (``LMOperators(
param_axis="model")``: parameter dots through ``vdot_sharded``, residual
dots over both axes), J·v through kernel E's plain version on the gathered
dual records, Jᵀ·u through the exchange's transpose. JAX's step runs on a
(2, 2) mesh of its 8 virtual CPU devices. The step is JAX's tests': 1 CG
iteration, 3 line-search step lengths, the tiny fixture's 4 views as
window and val set.

Tolerances, JAX's own (tests/test_parallel.py:236-259, 357-395, 439-460):
``best_val_loss`` within rtol 1e-4; xyz, scaling and exposure within 1e-5;
the best alpha equal; every group within 1e-5 of the port's single
process; both data rows' shards bit for bit equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu import config as j_config
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.parallel import make_mesh as j_make_mesh
from gslm_tpu.parallel import make_mp_lm_step as j_make_mp_lm_step
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from gslm_tpu_torch.train_lm import lm_outer_step
from torch_ranks import (LM, LM_PADDED, RCFG, STEP_KW, TINY, mp_lm_worker,
                         run_ranks, state_dict, tiny_scene)
from torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runs():
    return run_ranks(mp_lm_worker, 4)


@pytest.fixture(scope="module")
def single():
    """The port's single-process steps: the 4-view one and the 3-view
    one the padded window equals."""
    out = {}
    for name, lm, idx in (("whole", LM, [0, 1, 2, 3]),
                          ("padded", LM_PADDED, [0, 1, 2])):
        params, _, _, cams = tiny_scene()
        cams = cams.take(idx)
        new, info = lm_outer_step(params, params.alive, cams, cams,
                                  torch.zeros(3), rcfg=RCFG, lm=lm,
                                  **STEP_KW)
        out[name] = (state_dict(new), info)
    return out


def _whole(runs, name, g):
    if g == "exposure":
        return runs[0][name][g]
    return torch.cat([runs[m][name][g] for m in range(2)])


def _data_rows_equal(runs, name):
    for key in (name, f"{name}_info"):
        for r in (1, 2, 3):
            src = runs[r % 2] if key == name else runs[0]
            for k, v in src[key].items():
                assert (torch.equal(runs[r][key][k], v) if torch.is_tensor(v)
                        else runs[r][key][k] == v), (key, k, r)


def _held(runs, name, want, want_info, groups=PARAM_GROUPS):
    info = runs[0][f"{name}_info"]
    np.testing.assert_allclose(float(info["best_val_loss"]),
                               float(want_info["best_val_loss"]), rtol=1e-4)
    assert float(info["best_alpha"]) == float(want_info["best_alpha"])
    for g in groups:
        np.testing.assert_allclose(_whole(runs, name, g).numpy(),
                                   np.asarray(want[g]), rtol=0, atol=1e-5,
                                   err_msg=g)


@pytest.mark.parametrize("name", ["gather", "route"])
def test_mp_lm_step_matches_single(runs, single, name):
    _data_rows_equal(runs, name)
    _held(runs, name, *single["whole"])


@pytest.mark.parametrize("name,route", [("gather", 0), ("route", 256)])
def test_mp_lm_step_matches_jax(runs, name, route):
    """JAX's ``test_mp_lm_step_matches_single`` and
    ``test_mp_route_lm_step_matches_single``, the port's ranks against
    JAX's mesh."""
    jp, jaux = j_random_gaussians(np.random.default_rng(TINY["seed"]),
                                  n=TINY["n"], capacity=TINY["capacity"],
                                  num_images=TINY["views"])
    jcams = j_ring_camera_batch(TINY["views"], *TINY["hw"])
    jlm = j_config.LMParams(cg_max_iter=1, cg_restart_iter=1,
                            line_search_steps=2, num_val_views=4)
    step = j_make_mp_lm_step(
        j_make_mesh(2, 2), jp,
        rcfg=JRasterConfig(dup_capacity=1 << 12, mp_route_capacity=route),
        lm=jlm, **STEP_KW)
    ones = jnp.ones(4, jnp.float32)
    new, info = step(jp, jaux.alive, jcams, jcams, jnp.zeros(3), ones, ones)
    _held(runs, name, {g: getattr(new, g) for g in PARAM_GROUPS}, info,
          groups=("xyz", "scaling", "exposure"))


def test_mp_lm_step_with_padded_window(runs, single):
    """A 3-view window (and val set) padded to 4 with a zero-weight
    duplicate of view 0, 2 views per data row, equals the 3-view single
    step (JAX's test_dp_lm_step_with_padded_window_matches_single, whose
    mp half it is)."""
    _data_rows_equal(runs, "padded")
    _held(runs, "padded", *single["padded"])


def test_sharded_lm_step_is_the_mp_step(runs):
    """Above a model axis of 1 the GSPMD LM step's counterpart is the
    model-parallel step, bit for bit."""
    for o in runs:
        for key in ("gather", "gather_info"):
            for k, v in o[key].items():
                assert torch.equal(o[key.replace("gather", "sharded")][k],
                                   v), k
