"""gslm_tpu_torch.parallel's model-parallel Adam step (``make_mp_train_step``,
gathered and routed, and JAX's GSPMD name ``make_sharded_train_step``)
against the port's single-process ``train_step`` and gslm_tpu's
``make_mp_train_step``.

The port's ranks are 4 gloo processes on the CPU, a (2, 2) mesh
(``tests/torch_ranks.py``, spawned once for the module): each holds 128 of
the tiny fixture's 256 rows, renders 2 of its 4 views' bands through the
plain versions of kernels A, B and C. JAX's step runs on a (2, 2) mesh of
its 8 virtual CPU devices (tests/conftest.py), through its XLA tile
pipeline. The depth weight is 0.1, as JAX's tests take it.

Tolerances, JAX's own (tests/test_parallel.py:146-173, 408-436): the loss
within 1e-6; xyz, scaling, opacity, rotation, exposure and
``xyz_gradient_accum`` within 1e-5 (every group against the port's single
process); both data rows' shards bit for bit equal. Against JAX the
updated parameters are held only where the gradient exceeds 1e-3 of its
group's largest (tests/test_torch_parallel.py: Adam's first step moves a
parameter by about ±lr whatever its gradient's size)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu import config as j_config
from gslm_tpu.optim import init_adam as j_init_adam
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.parallel import make_mesh as j_make_mesh
from gslm_tpu.parallel import make_mp_train_step as j_make_mp_train_step
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.config import OptimizationParams
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from gslm_tpu_torch.train import train_step
from torch_ranks import (ADAM_KW, RCFG, TINY, mp_adam_worker, run_ranks,
                         state_dict, tiny_scene)

GROUPS = ("xyz", "scaling", "opacity", "rotation", "exposure")


@pytest.fixture(scope="module")
def runs():
    return run_ranks(mp_adam_worker, 4)


@pytest.fixture(scope="module")
def single():
    params, aux, opt_state, cams = tiny_scene()
    params, aux, opt_state, metrics = train_step(
        params, aux, opt_state, cams, torch.zeros(3), 1, 1.0, 0.1,
        rcfg=RCFG, opt=OptimizationParams(), **ADAM_KW)
    return state_dict(params, aux, opt_state), metrics


def _whole(runs, name, k):
    if k in ("exposure", "mu/exposure", "nu/exposure", "step"):
        return runs[0][name][k]
    return torch.cat([runs[m][name][k] for m in range(2)])


def _jax(route: int):
    jp, jaux = j_random_gaussians(np.random.default_rng(TINY["seed"]),
                                  n=TINY["n"], capacity=TINY["capacity"],
                                  num_images=TINY["views"])
    jcams = j_ring_camera_batch(TINY["views"], *TINY["hw"])
    jopt = j_init_adam(jp)
    step = j_make_mp_train_step(
        j_make_mesh(2, 2), jp, jopt,
        rcfg=JRasterConfig(dup_capacity=1 << 12, mp_route_capacity=route),
        opt=j_config.OptimizationParams(), **ADAM_KW)
    return step(jp, jaux, jopt, jcams, jnp.zeros(3), jnp.int32(1),
                jnp.float32(1.0), jnp.float32(0.1))


def _data_rows_equal(runs, name):
    for r in (2, 3):
        for k, v in runs[r - 2][name].items():
            assert (torch.equal(runs[r][name][k], v) if torch.is_tensor(v)
                    else runs[r][name][k] == v), (name, k)
    for k in ("exposure", "mu/exposure", "nu/exposure"):
        assert torch.equal(runs[0][name][k], runs[1][name][k]), k


@pytest.mark.parametrize("name", ["gather", "route"])
def test_mp_train_step_matches_single(runs, single, name):
    _data_rows_equal(runs, name)
    want, want_m = single
    metrics = runs[0][f"{name}_metrics"]
    assert abs(float(metrics["loss"]) - float(want_m["loss"])) <= 1e-6
    assert abs(float(metrics["depth_l1"])
               - float(want_m["depth_l1"])) <= 1e-6
    for k in ("l1", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("overflow", "max_tile_load"):
        assert int(metrics[k]) == int(want_m[k]), k
    for g in PARAM_GROUPS:
        np.testing.assert_allclose(_whole(runs, name, g).numpy(),
                                   want[g].numpy(), rtol=0, atol=1e-5,
                                   err_msg=g)
    np.testing.assert_allclose(
        _whole(runs, name, "xyz_gradient_accum").numpy(),
        want["xyz_gradient_accum"].numpy(), rtol=0, atol=1e-5)
    for k in ("alive", "max_radii2d", "denom"):
        assert torch.equal(_whole(runs, name, k), want[k]), k
    assert _whole(runs, name, "step") == want["step"] == 1


@pytest.mark.parametrize("name,route", [("gather", 0), ("route", 256)])
def test_mp_train_step_matches_jax(runs, name, route):
    """JAX's ``test_mp_shard_map_train_step_matches_single`` and
    ``test_mp_route_train_step_matches_single``, the port's ranks against
    JAX's mesh."""
    jp, jaux, jopt, jm = _jax(route)
    metrics = runs[0][f"{name}_metrics"]
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-6
    assert abs(float(metrics["depth_l1"]) - float(jm["depth_l1"])) <= 1e-6
    assert int(metrics["overflow"]) == int(jm["overflow"]) == 0
    for g in GROUPS:
        mu = np.abs(np.asarray(getattr(jopt.mu, g)))
        sure = mu > 1e-3 * mu.max(initial=0.0)
        want = np.asarray(getattr(jp, g))
        np.testing.assert_allclose(_whole(runs, name, g).numpy()[sure],
                                   want[sure], rtol=0, atol=1e-5, err_msg=g)
    np.testing.assert_allclose(
        _whole(runs, name, "xyz_gradient_accum").numpy(),
        np.asarray(jaux.xyz_gradient_accum), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_whole(runs, name, "denom").numpy(),
                                  np.asarray(jaux.denom))


def test_sharded_train_step_is_the_mp_step(runs):
    """Above a model axis of 1 the GSPMD step's counterpart is the
    model-parallel step, bit for bit."""
    for o in runs:
        for k, v in o["gather"].items():
            assert (torch.equal(o["sharded"][k], v) if torch.is_tensor(v)
                    else o["sharded"][k] == v), k
