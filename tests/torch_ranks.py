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


def odd_params():
    """The tiny fixture's first 6 Gaussians in 6 slots: on a model axis of
    2 each shard holds 3 rows, not a multiple of the axis."""
    return random_gaussians(np.random.default_rng(TINY["seed"]), n=6,
                            capacity=6, num_images=TINY["views"],
                            device="cpu")


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
           "model_shape": make_mesh(world // 2, 2).shape,
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


# ---- the model axis --------------------------------------------------------

RCFG_ROUTE = RasterConfig(dup_capacity=1 << 12, mp_route_capacity=256)
RENDER_BG = (0.2, 0.1, 0.3)
DENSIFY_ARGS = (0.5, 0.005, 1.0, 0.0, 0.01)


def hot_stats(aux) -> None:
    """Deterministic densification statistics: every 5th Gaussian hot
    (JAX's tests/test_parallel.py:264-270)."""
    aux.xyz_gradient_accum[::5] = 1.0
    aux.denom[:] = 1.0


def mp_state_worker(rank: int, world: int, ckpt_dir: str, noise: list,
                    mu_xyz: np.ndarray) -> dict:
    """On a (2, 2) mesh of 4 ranks: the mesh shapes and groups;
    ``mp_render_views`` of the tiny fixture's views (gathered, routed at
    R = 256 and at R = 8) and ``band_probe`` (also on ``odd_params``,
    shards of 3 rows); the sharded checkpoint round
    trip through ``ckpt_dir``; ``make_mp_densify`` without its rebalance on
    ``hot_stats`` with the whole-capacity split noise ``noise``. On a (1, 4)
    mesh of the same ranks: ``mp_rebalance`` of the fixture (all 48 alive
    rows on shard 0), the xyz first moment ``mu_xyz``."""
    from gslm_tpu_torch.checkpoint import (load_checkpoint_sharded,
                                           save_checkpoint_sharded)
    from gslm_tpu_torch.parallel import make_mesh, make_mp_densify, shard_state
    from gslm_tpu_torch.parallel.mesh import all_reduce
    from gslm_tpu_torch.parallel.model_raster import (band_probe,
                                                      mp_rebalance,
                                                      mp_render_views)
    mesh = make_mesh(2, 2)
    row = make_mesh(1, 4)
    out = {"shape": mesh.shape, "rank": mesh.rank,
           "model_rank": mesh.model_rank, "is_main": mesh.is_main,
           "row_shape": row.shape, "row_rank": (row.rank, row.model_rank),
           "misfit_raises": _raises(lambda: make_mesh(2, 3), ValueError),
           "capacity_raises": _raises(lambda: mesh.rows(255), ValueError)}
    # each axis's group sums over its ranks
    r = torch.tensor([float(rank)])
    out["sums"] = [float(all_reduce([r], "sum", g)[0])
                   for g in (mesh.group, mesh.model_group, mesh.world_group,
                             row.model_group)]
    params, aux, opt_state, cams = tiny_scene()
    params, aux, opt_state = shard_state(mesh, params, aux, opt_state)
    out["state"] = state_dict(params, aux, opt_state)
    mine = cams.take(mesh.block(cams.batch_size))
    bg = torch.tensor(RENDER_BG)
    for name, cfg in (("gather", RCFG), ("route", RCFG_ROUTE),
                      ("route8", RCFG.replace(mp_route_capacity=8))):
        with torch.no_grad():
            img, invd, radii, diags = mp_render_views(
                params, mine, bg, config=cfg, mesh=mesh)
        out[name] = {"image": img, "invdepth": invd, "radii": radii,
                     "overflow": int(all_reduce([diags["overflow"]], "max",
                                                mesh.world_group)[0])}
    out["probe"] = band_probe(params, mine, config=RCFG_ROUTE, mesh=mesh)
    out["probe_odd"] = band_probe(shard_state(mesh, odd_params()), mine,
                                  config=RCFG_ROUTE, mesh=mesh)

    save_checkpoint_sharded(ckpt_dir, params, aux, opt_state, 777, 3.25,
                            mesh=mesh)
    out["ckpt_files"] = sorted(os.listdir(ckpt_dir))
    p2, a2, o2, it, slr = load_checkpoint_sharded(ckpt_dir, mesh=mesh,
                                                  device="cpu")
    out["ckpt_mine"] = (state_dict(p2, a2, o2), it, slr)
    out["ckpt_whole"] = state_dict(*load_checkpoint_sharded(
        ckpt_dir, device="cpu")[:3])
    out["ckpt_row"] = state_dict(*load_checkpoint_sharded(
        ckpt_dir, mesh=row, device="cpu")[:3])

    params, aux, opt_state, _ = tiny_scene()
    hot_stats(aux)
    params, aux, opt_state = shard_state(mesh, params, aux, opt_state)
    step = make_mp_densify(mesh, params, opt_state, rebalance=False)
    params, aux, opt_state, info = step(
        params, aux, opt_state, tuple(torch.tensor(n) for n in noise),
        *DENSIFY_ARGS)
    out["densify"] = {k: int(v) for k, v in info.items()}
    out["densify_state"] = state_dict(params, aux, opt_state)

    params, aux, opt_state, _ = tiny_scene()
    opt_state.mu["xyz"].copy_(torch.tensor(mu_xyz))
    params, aux, opt_state = shard_state(row, params, aux, opt_state)
    params, aux, opt_state, moved = mp_rebalance(params, aux, opt_state,
                                                 mesh=row, donate_cap=64)
    out["rebalance"] = state_dict(params, aux, opt_state)
    out["moved"] = int(moved)
    return out


def mp_adam_worker(rank: int, world: int) -> dict:
    """``make_mp_train_step`` on a (2, 2) mesh, gathered and routed (R =
    256), and ``make_sharded_train_step`` (JAX's GSPMD name), each from the
    tiny fixture's state: this rank's shard after the step, the metrics."""
    from gslm_tpu_torch.parallel import (make_mesh, make_mp_train_step,
                                         make_sharded_train_step,
                                         shard_state)
    mesh = make_mesh(2, 2)
    out = {}
    args = (torch.zeros(3), 1, 1.0, 0.1)
    for name, cfg in (("gather", RCFG), ("route", RCFG_ROUTE),
                      ("sharded", RCFG)):
        kw = dict(ADAM_KW, rcfg=cfg, opt=OptimizationParams())
        params, aux, opt_state, cams = tiny_scene()
        params, aux, opt_state = shard_state(mesh, params, aux, opt_state)
        if name == "sharded":
            step = make_sharded_train_step(mesh, params, aux, opt_state,
                                           cams, **kw)
        else:
            step = make_mp_train_step(mesh, params, opt_state, **kw)
        params, aux, opt_state, metrics = step(params, aux, opt_state, cams,
                                               *args)
        out[name] = state_dict(params, aux, opt_state)
        out[f"{name}_metrics"] = {k: v.clone() for k, v in metrics.items()}
    return out


def mp_lm_worker(rank: int, world: int) -> dict:
    """On a (2, 2) mesh: ``make_mp_lm_step`` on the tiny fixture's 4 views
    (window and val), gathered and routed (R = 256), the padded 3-view
    window, and ``make_sharded_lm_step`` (JAX's GSPMD name)."""
    from gslm_tpu_torch.parallel import (make_mesh, make_mp_lm_step,
                                         make_sharded_lm_step, shard_state)
    mesh = make_mesh(2, 2)
    bg = torch.zeros(3)
    out = {}
    for name, cfg, lm, idx, w in (
            ("gather", RCFG, LM, [0, 1, 2, 3], [1.0] * 4),
            ("route", RCFG_ROUTE, LM, [0, 1, 2, 3], [1.0] * 4),
            ("padded", RCFG, LM_PADDED, [0, 1, 2, 0], [1.0, 1.0, 1.0, 0.0])):
        params, _, _, cams = tiny_scene()
        params = shard_state(mesh, params)
        w = torch.tensor(w)
        win = cams.take(idx)
        new, info = make_mp_lm_step(mesh, params, rcfg=cfg, lm=lm,
                                    **STEP_KW)(params, params.alive, win, win,
                                               bg, w, w)
        out[name] = state_dict(new)
        out[f"{name}_info"] = {k: v.clone() for k, v in info.items()}
    params, _, _, cams = tiny_scene()
    params = shard_state(mesh, params)
    new, info = make_sharded_lm_step(mesh, params, cams, cams, rcfg=RCFG,
                                     lm=LM, **STEP_KW)(
        params, params.alive, cams, cams, bg)
    out["sharded"] = state_dict(new)
    out["sharded_info"] = {k: v.clone() for k, v in info.items()}
    return out


def mp_trainer_worker(rank: int, world: int, argv: list, noise: list,
                      lm_argv: list) -> dict:
    """``train.main(argv)`` (``--mesh_data 2 --mesh_model 2``) with the
    split noise of each density event taken from ``noise`` in order, then
    ``train_lm.main(lm_argv)``. Returns this rank's shard after each, the
    density events' counts, the test evaluations and the LM steps'
    infos."""
    from gslm_tpu_torch import train, train_lm
    from gslm_tpu_torch.parallel import steps
    draws = iter(noise)
    train.split_noise = lambda gen, capacity, device: tuple(
        torch.tensor(a) for a in next(draws))
    events, evals, lm_infos = [], [], []
    make_densify, evaluate, lm_phase = (steps.make_mp_densify, train.evaluate,
                                        train_lm.lm_phase)

    def densify_factory(*a, **k):
        step = make_densify(*a, **k)

        def recorded(*a, **k):
            out = step(*a, **k)
            events.append({n: int(v) for n, v in out[3].items()})
            return out
        return recorded

    def evaluated(*a, **k):
        out = evaluate(*a, **k)
        evals.append(out)
        return out

    def lm_recorded(*a, **k):
        out = lm_phase(*a, **k)
        lm_infos.append({n: float(out[1][n]) for n in ("start_loss",
                                                       "best_val_loss",
                                                       "best_alpha")})
        return out

    steps.make_mp_densify = densify_factory
    train.evaluate = evaluated
    train_lm.lm_phase = lm_recorded
    saved = sys.stdout
    try:
        _, params, aux, opt_state = train.main(argv)
        out = {"adam": state_dict(params, aux, opt_state)}
        _, params, aux, opt_state = train_lm.main(lm_argv)
        out["lm"] = state_dict(params)
    finally:
        sys.stdout = saved
    return out | {"events": events, "evals": evals, "lm_infos": lm_infos}
