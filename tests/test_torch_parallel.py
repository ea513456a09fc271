"""gslm_tpu_torch.parallel's mesh and data-parallel Adam step against the
port's single process and gslm_tpu's data-parallel step.

The port's ranks are gloo processes on the CPU (``tests/torch_ranks.py``:
spawned, one 180 s join timeout per spawn); JAX's mesh is its 8 virtual
CPU devices (tests/conftest.py), its step ``make_dp_train_step`` on
``make_mesh(n, 1)`` through its XLA tile pipeline, the port's through the
plain versions of kernels A, B and C. The scene is JAX's ``tiny`` fixture
(tests/test_parallel.py): 48 Gaussians in 256 slots, 4 ring views at
32x32.

Tolerances, JAX's own (tests/test_parallel.py:118-143): the loss within
1e-6, parameters within 1e-5, ``xyz_gradient_accum`` within 1e-5; every
rank's state bit for bit equal to every other's. Against JAX the updated
parameters are held only where the gradient exceeds 1e-3 of its group's
largest (tests/test_torch_train.py: with eps = 1e-15 Adam's first step
moves a parameter by about ±lr whatever the gradient's size, so rounding
noise in a tiny gradient can flip its sign)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu import config as j_config
from gslm_tpu.optim import init_adam as j_init_adam
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.parallel import make_dp_train_step as j_make_dp_train_step
from gslm_tpu.parallel import make_mesh as j_make_mesh
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.utils.synthetic import ring_camera_batch as j_ring_camera_batch
from gslm_tpu_torch.config import OptimizationParams
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from gslm_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
from gslm_tpu_torch.train import train_step
from torch_ranks import (ADAM_KW, RCFG, TINY, adam_worker, free_port,
                         run_ranks, state_dict, tiny_scene)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def adam_runs():
    """Each world size's ranks (``adam_worker``), spawned once."""
    return {w: run_ranks(adam_worker, w) for w in WORLDS}


@pytest.fixture(scope="module")
def single():
    """The port's single-process ``train_step`` on the same 4 views."""
    params, aux, opt_state, cams = tiny_scene()
    params, aux, opt_state, metrics = train_step(
        params, aux, opt_state, cams, torch.zeros(3), 1, 1.0, 0.0,
        rcfg=RCFG, opt=OptimizationParams(), **ADAM_KW)
    return state_dict(params, aux, opt_state), metrics


def _jax_dp(world: int):
    """JAX's data-parallel step on a (world, 1) mesh of its CPU devices."""
    jp, jaux = j_random_gaussians(np.random.default_rng(TINY["seed"]),
                                  n=TINY["n"], capacity=TINY["capacity"],
                                  num_images=TINY["views"])
    jcams = j_ring_camera_batch(TINY["views"], *TINY["hw"])
    step = j_make_dp_train_step(
        j_make_mesh(world, 1), rcfg=JRasterConfig(dup_capacity=1 << 12),
        opt=j_config.OptimizationParams(), **ADAM_KW)
    return step(jp, jaux, j_init_adam(jp), jcams, jnp.zeros(3),
                jnp.int32(1), jnp.float32(1.0), jnp.float32(0.0))


def _bitwise_equal_ranks(outs, key):
    first = outs[0][key]
    for r, o in enumerate(outs[1:], 1):
        for k, v in first.items():
            if torch.is_tensor(v):
                assert torch.equal(o[key][k], v), (r, key, k)
            else:
                assert o[key][k] == v, (r, key, k)


def test_mesh_shapes(adam_runs):
    """The 1x1 mesh of the single process; (2, 1) and (4, 1) over gloo
    ranks, the default filling the data axis, and (1, 2) or (2, 2) with a
    model axis (tests/test_torch_mp_render.py holds its groups); a mesh
    that does not fill the world raises; the rank's default device raises
    without CUDA."""
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert (mesh.rank, mesh.group, mesh.is_main) == (0, None, True)
    assert make_mesh(1, 1) == mesh == make_mesh(n_data=1)
    with pytest.raises(ValueError, match="fill the world"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="fill the world"):
        make_mesh(2, 1)
    assert mesh.block(6) == slice(0, 6)
    for world, outs in adam_runs.items():
        assert [o["rank"] for o in outs] == list(range(world))
        for o in outs:
            assert o["shape"] == o["default_shape"] == {"data": world,
                                                        "model": 1}
            assert o["model_shape"] == {"data": world // 2, "model": 2}
            assert o["misfit_raises"]
            # under a process group, no CUDA still raises (no drift)
            assert o["device_raises"] == (not o["cuda"])


def test_maybe_initialize_distributed(monkeypatch):
    """Without torchrun's variables: no group. With them (a world of one
    gloo rank): the group starts, a second call passes through, and the
    mesh takes the world group."""
    import torch.distributed as dist
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed("gloo") is False
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(ValueError, match="nccl"):
        maybe_initialize_distributed("mpi")
    try:
        assert maybe_initialize_distributed("gloo") is True
        assert dist.get_backend() == "gloo"
        assert maybe_initialize_distributed("nccl") is True   # passes through
        mesh = make_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.group is dist.group.WORLD and mesh.rank == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", WORLDS)
def test_dp_train_step_matches_single(adam_runs, single, world):
    outs = adam_runs[world]
    _bitwise_equal_ranks(outs, "dp")
    _bitwise_equal_ranks(outs, "dp_metrics")
    got, metrics = outs[0]["dp"], outs[0]["dp_metrics"]
    want, want_metrics = single
    assert abs(float(metrics["loss"]) - float(want_metrics["loss"])) <= 1e-6
    for k in ("l1", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("overflow", "max_tile_load"):
        assert int(metrics[k]) == int(want_metrics[k]), k
    for g in PARAM_GROUPS:
        np.testing.assert_allclose(got[g].numpy(), want[g].numpy(), rtol=0,
                                   atol=1e-5, err_msg=g)
    np.testing.assert_allclose(got["xyz_gradient_accum"].numpy(),
                               want["xyz_gradient_accum"].numpy(), rtol=0,
                               atol=1e-5)
    for k in ("alive", "max_radii2d", "denom"):
        assert torch.equal(got[k], want[k]), k
    assert got["step"] == want["step"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_dp_train_step_matches_jax(adam_runs, world):
    jp, jaux, jopt, jm = _jax_dp(world)
    got, metrics = adam_runs[world][0]["dp"], adam_runs[world][0]["dp_metrics"]
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-6
    for g in PARAM_GROUPS:
        mu = np.abs(np.asarray(getattr(jopt.mu, g)))
        sure = mu > 1e-3 * mu.max(initial=0.0)
        want = np.asarray(getattr(jp, g))
        np.testing.assert_allclose(got[g].numpy()[sure], want[sure], rtol=0,
                                   atol=1e-5, err_msg=g)
    np.testing.assert_allclose(got["xyz_gradient_accum"].numpy(),
                               np.asarray(jaux.xyz_gradient_accum), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["denom"].numpy(), np.asarray(jaux.denom))
    np.testing.assert_array_equal(got["alive"].numpy(), np.asarray(jaux.alive))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_train_step_equals_dp(adam_runs, world):
    """At a model axis of 1 the GSPMD step's counterpart is the
    data-parallel step, bit for bit."""
    for o in adam_runs[world]:
        for k, v in o["dp"].items():
            assert (torch.equal(o["sharded"][k], v) if torch.is_tensor(v)
                    else o["sharded"][k] == v), k
