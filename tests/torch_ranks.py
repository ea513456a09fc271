"""Rank workers of the port's data-parallel tests, and the spawner that
runs them as ``torch.distributed`` gloo ranks on the CPU.

The spawned ranks import this module, so its top level imports only
torch, numpy and the port (no JAX: the references are computed in the
test process). Each worker takes ``(rank, world, *args)`` inside a gloo
group that ``run_ranks`` started and returns a dict of CPU tensors and
plain values, which ``run_ranks`` hands back per rank.
"""

from __future__ import annotations

import os
import pathlib
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from gslm_tpu_torch.config import LMParams, OptimizationParams
from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, GaussianAux
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.optim import init_adam
from gslm_tpu_torch.utils.synthetic import random_gaussians, ring_camera_batch

# JAX's tiny fixture (tests/test_parallel.py): 48 Gaussians in 256 slots,
# 4 ring views at 32x32
TINY = dict(seed=3, n=48, capacity=256, views=4, hw=(32, 32))
RCFG = RasterConfig(dup_capacity=1 << 12)
STEP_KW = dict(active_sh_degree=3, use_exp=False)
ADAM_KW = dict(STEP_KW, sparse_adam=False, update_stats=True)
LM = LMParams(cg_max_iter=1, cg_restart_iter=1, line_search_steps=2,
              num_val_views=4)
LM_PADDED = LMParams(cg_max_iter=1, cg_restart_iter=1, line_search_steps=2,
                     num_val_views=3, micro_batch=0)
SPAWN_TIMEOUT = 180.0        # seconds per spawn, then the ranks are killed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = SPAWN_TIMEOUT) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks on the
    CPU (127.0.0.1, a free port). Returns each rank's result. A rank that
    raises fails the call with its traceback; ranks still running after
    ``timeout`` seconds are killed and the call fails."""
    with tempfile.TemporaryDirectory(prefix="gslm_ranks_") as out_dir:
        ctx = mp.start_processes(
            _entry, args=(fn, world, free_port(), out_dir, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} on {world} ranks: "
                                       f"still running after {timeout} s")
        except ProcessException as e:
            errs = [pathlib.Path(out_dir, f).read_text()
                    for f in sorted(os.listdir(out_dir))
                    if f.endswith(".err")]
            raise RuntimeError("a rank failed:\n" + "\n".join(errs)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def tiny_scene():
    """The tiny fixture on the CPU: (params, aux, opt_state, cams)."""
    params = random_gaussians(np.random.default_rng(TINY["seed"]),
                              n=TINY["n"], capacity=TINY["capacity"],
                              num_images=TINY["views"], device="cpu")
    cams = ring_camera_batch(TINY["views"], *TINY["hw"], device="cpu")
    return (params, GaussianAux.zeros(params.capacity, "cpu"),
            init_adam(params), cams)


def state_dict(params, aux=None, opt_state=None) -> dict:
    """Every tensor of a training state, detached CPU copies by name."""
    out = {g: getattr(params, g).detach().clone() for g in PARAM_GROUPS}
    out["alive"] = params.alive.clone()
    if aux is not None:
        for f in ("max_radii2d", "xyz_gradient_accum", "denom"):
            out[f] = getattr(aux, f).clone()
    if opt_state is not None:
        for g in PARAM_GROUPS:
            out[f"mu/{g}"] = opt_state.mu[g].clone()
            out[f"nu/{g}"] = opt_state.nu[g].clone()
        out["step"] = opt_state.step
    return out


def info_dict(info: dict) -> dict:
    """An LM step's info as CPU tensors (step norms flattened)."""
    out = {k: v.detach().clone() for k, v in info.items()
           if k != "step_norms"}
    out.update({f"norm/{g}": v.detach().clone()
                for g, v in info["step_norms"].items()})
    return out


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


# ---- workers ---------------------------------------------------------------

def adam_worker(rank: int, world: int) -> dict:
    """The mesh shapes, then ``make_dp_train_step`` and (on fresh state)
    ``make_sharded_train_step`` on the tiny fixture's 4 views."""
    from gslm_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                         make_sharded_train_step, shard_state)
    mesh = make_mesh(world, 1)
    out = {"shape": mesh.shape, "default_shape": make_mesh().shape,
           "rank": mesh.rank,
           "model_raises": _raises(lambda: make_mesh(world // 2 or 1, 2),
                                   NotImplementedError),
           "misfit_raises": _raises(lambda: make_mesh(world + 1, 1),
                                    ValueError),
           "cuda": torch.cuda.is_available(),
           "device_raises": _raises(resolve_device, RuntimeError)}
    bg = torch.zeros(3)
    args = (bg, 1, 1.0, 0.0)
    kw = dict(ADAM_KW, rcfg=RCFG, opt=OptimizationParams())
    params, aux, opt_state, cams = tiny_scene()
    shard_state(mesh, params, aux, opt_state)
    params, aux, opt_state, metrics = make_dp_train_step(mesh, **kw)(
        params, aux, opt_state, cams, *args)
    out["dp"] = state_dict(params, aux, opt_state)
    out["dp_metrics"] = {k: v.clone() for k, v in metrics.items()}
    params, aux, opt_state, cams = tiny_scene()
    step = make_sharded_train_step(mesh, params, aux, opt_state, cams, **kw)
    params, aux, opt_state, _ = step(params, aux, opt_state, cams, *args)
    out["sharded"] = state_dict(params, aux, opt_state)
    return out


def lm_worker(rank: int, world: int) -> dict:
    """``make_dp_lm_step`` on the tiny fixture's 4 views (window and val),
    the padded 3-view window, and ``make_sharded_lm_step``."""
    from gslm_tpu_torch.parallel import (make_dp_lm_step, make_mesh,
                                         make_sharded_lm_step)
    mesh = make_mesh(world, 1)
    params, _, _, cams = tiny_scene()
    bg = torch.zeros(3)
    kw = dict(STEP_KW, rcfg=RCFG)
    ones = torch.ones(cams.batch_size)
    new, info = make_dp_lm_step(mesh, lm=LM, **kw)(
        params, params.alive, cams, cams, bg, ones, ones)
    out = {"dp": state_dict(new), "dp_info": info_dict(info)}
    pad = [0, 1, 2, 0]
    w = torch.tensor([1.0, 1.0, 1.0, 0.0])
    new, info = make_dp_lm_step(mesh, lm=LM_PADDED, **kw)(
        params, params.alive, cams.take(pad), cams.take(pad), bg, w, w)
    out["padded"] = state_dict(new)
    out["padded_info"] = info_dict(info)
    new, info = make_sharded_lm_step(mesh, params, cams, cams, lm=LM, **kw)(
        params, params.alive, cams, cams, bg)
    out["sharded"] = state_dict(new)
    out["sharded_info"] = info_dict(info)
    return out


def lm_phase_worker(rank: int, world: int, lm_kw: dict, caps: list) -> dict:
    """``lm_phase(mesh=)`` on the tiny fixture, once per capacity in
    ``caps`` (dup_capacity = live_capacity), each from a fresh
    ``default_rng(0)``: the grown capacities, the new state and info."""
    from gslm_tpu_torch.parallel import make_mesh
    from gslm_tpu_torch.train_lm import lm_phase
    mesh = make_mesh(world, 1)
    params, _, _, cams = tiny_scene()
    out = {}
    for cap in caps:
        cfg = RasterConfig(dup_capacity=cap, live_capacity=cap)
        new, info, grown = lm_phase(None, params, None, cams, cfg,
                                    torch.zeros(3), LMParams(**lm_kw), 0,
                                    np.random.default_rng(0), False, 0.2, 3,
                                    verbose=False, mesh=mesh)
        out[cap] = {"dup": grown.dup_capacity, "live": grown.live_capacity,
                    "state": state_dict(new), "info": info_dict(info)}
    return out


def trainer_worker(rank: int, world: int, argv: list, noise: list,
                   entry: str = "train") -> dict:
    """``gslm_tpu_torch.<entry>.main(argv)`` (``--mesh_data``) with the
    split noise of each density event taken from ``noise`` in order (JAX's
    own draws, made by the test). Counts this rank's calls of the
    functions that write the model directory."""
    import importlib

    from gslm_tpu_torch import config, train
    from gslm_tpu_torch.models import scene as scene_mod
    draws = iter(noise)
    train.split_noise = lambda gen, capacity, device: tuple(
        torch.tensor(a) for a in next(draws))
    writes = []

    def counted(owner, name):
        real = getattr(owner, name)

        def call(*a, **k):
            writes.append(name)
            return real(*a, **k)
        setattr(owner, name, call)

    counted(train, "save_checkpoint")
    counted(config, "save_cfg_args")
    counted(scene_mod, "store_point_cloud")
    counted(scene_mod.Scene, "save")
    saved = sys.stdout
    try:
        scene, params, aux, opt_state = importlib.import_module(
            f"gslm_tpu_torch.{entry}").main(argv)
    finally:
        sys.stdout = saved
    return {"state": state_dict(params, aux, opt_state),
            "extent": scene.cameras_extent, "writes": writes}
