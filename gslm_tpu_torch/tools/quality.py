"""LM against Adam at equal render budget, from an Adam plateau (the JAX
repository's tests/quality_harness.py and scripts/quality_lm_vs_adam.py).

The scene is hard on purpose: the ground truth is rendered from a rich
random Gaussian set, so it is exactly representable but far from the
start, a ten times smaller subset of it, jittered, grey and nearly
transparent, that must densify its way up. Adam with densification runs
to a plateau. From there two branches run: (a) more Adam steps and (b)
the LM outer steps that cost the same in renders
(``lm_cost_in_adam_steps``). Their PSNR gains over the plateau are
compared.

Every numpy draw is the JAX harness's, in its order, so a seed gives the
same problem, views and LM windows in both packages. The split noise of
each densification event comes from a ``torch.Generator`` seeded with the
run's seed through ``train.split_noise`` (``jax.random`` draws cannot be
repeated); ``run_adam(noise_fn=...)`` takes other draws.

Usage: python -m gslm_tpu_torch.tools.quality [--small|--large] [--seeds N]
       [--win W --cg K --ls S] [--platform cpu]
(on the card; ``--platform cpu`` runs on the CPU)
"""

from __future__ import annotations

import time
from argparse import ArgumentParser

import numpy as np
import torch

from gslm_tpu_torch import train as t_train
from gslm_tpu_torch.config import LMParams, OptimizationParams
from gslm_tpu_torch.densify import densify_and_prune
from gslm_tpu_torch.device import platform_device, resolve_device
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                             GaussianParams)
from gslm_tpu_torch.ops import blur_cuda, rasterize_cuda
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.optim import init_adam
from gslm_tpu_torch.renderer import batch_render
from gslm_tpu_torch.train_lm import lm_outer_step, select_window
from gslm_tpu_torch.utils.image import psnr
from gslm_tpu_torch.utils.synthetic import random_gaussians, ring_camera_batch

# the script's three sizes: the problem's keywords, the plateau's Adam
# iterations, the last densifying iteration, and the steps each branch
# gets after the plateau (in Adam steps)
SIZES = {
    "small": dict(kw=dict(n_rich=400, n_init=60, capacity=1024, n_views=6,
                          hw=64),
                  iters=1400, dens_until=900, extra=200),
    # plateau regime: a capacity-bounded model on a hard scene, a long Adam
    # schedule so that first-order progress has stalled
    "default": dict(kw=dict(n_rich=6000, n_init=400, capacity=2048,
                            n_views=8, hw=128, dup_capacity=1 << 20),
                    iters=6000, dens_until=1500, extra=400),
    "large": dict(kw=dict(n_rich=120_000, n_init=8_000, capacity=131_072,
                          n_views=8, hw=256, dup_capacity=1 << 21),
                  iters=6000, dens_until=1500, extra=400),
}


def default_lm(**over) -> LMParams:
    """The harness's LM settings: a 4-view window, 4 validation views,
    CG 2 with restart 1, 7 line-search alphas."""
    kw = dict(num_images=4, num_val_views=4, val_view_stride=1,
              cg_max_iter=2, cg_restart_iter=1, line_search_steps=6)
    kw.update(over)
    return LMParams(**kw)


def build_problem(n_rich=1500, n_init=150, capacity=4096, n_views=8, hw=96,
                  seed=0, dup_capacity=1 << 15, *, device=None, info=None):
    """Returns ``(params0, aux0, cams, rcfg, bg)``: the sparse start, its
    zeroed statistics, ``n_views`` ring cameras whose targets are the rich
    set's renders, the raster config and the black background. ``info``,
    a dict if given, receives the ground truth's largest record count in
    one tile (``gt_max_tile_load``).

    The JAX harness sets ``max_per_tile=1024`` and ``tile_chunk=8`` for its
    XLA tile path, which truncates a tile's segment there; the port walks
    whole segments (``RasterConfig`` has neither field)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rich = random_gaussians(rng, n=n_rich, capacity=n_rich,
                            num_images=n_views, spread=1.2,
                            scale_range=(-3.5, -2.2), device=dev)
    cams = ring_camera_batch(n_views, hw, hw, device=dev)
    bg = torch.zeros(3, device=dev)
    rcfg = RasterConfig(dup_capacity=dup_capacity)
    with torch.no_grad():
        out = batch_render(rich, cams, bg, config=rcfg, alive=rich.alive)
    cams = cams.replace(gt_image=out.render)
    if info is not None:
        info["gt_max_tile_load"] = int(torch.amax(out.max_tile_load))

    # sparse noisy start: a subset of the rich cloud, positions jittered,
    # colours grey, opacity low: far from the optimum
    idx = rng.choice(n_rich, n_init, replace=False)
    rich_np = {g: getattr(rich, g).detach().cpu().numpy()
               for g in PARAM_GROUPS}

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, x.dtype)
        out[:n_init] = x[idx]
        return out.astype(np.float32)

    groups = dict(
        xyz=pad(rich_np["xyz"] + rng.normal(0, 0.05, (n_rich, 3))),
        features_dc=pad(np.zeros_like(rich_np["features_dc"])),
        features_rest=pad(np.zeros_like(rich_np["features_rest"])),
        scaling=pad(rich_np["scaling"], fill=-8.0),
        rotation=pad(rich_np["rotation"]),
        opacity=pad(np.full_like(rich_np["opacity"], -1.0), fill=-8.0))
    groups["rotation"][:, 0] = 1.0
    alive = torch.arange(capacity, device=dev) < n_init
    params0 = GaussianParams(
        **{g: torch.tensor(v, device=dev) for g, v in groups.items()},
        exposure=rich.exposure.detach().clone(), sh_degree=rich.sh_degree,
        alive=alive)
    return params0, GaussianAux.zeros(capacity, dev), cams, rcfg, bg


def _copy(params: GaussianParams, aux: GaussianAux):
    """Copies of ``params`` and ``aux``: the loops update in place, and the
    harness's callers branch from one state."""
    p = GaussianParams(**{g: getattr(params, g).detach().clone()
                          for g in PARAM_GROUPS},
                       sh_degree=params.sh_degree, alive=params.alive.clone())
    return p, aux.replace(**{k: v.clone() for k, v in vars(aux).items()})


def run_adam(params, aux, cams, rcfg, bg, *, iters, seed=1, densify_every=100,
             densify_from=100, densify_until=10_000, extent=1.5,
             lr_scale=1.5, start_iter=0, opt=None, noise_fn=None, out=None):
    """Plain Adam over random single views with densification, on copies of
    ``params`` and ``aux`` (fresh moments, as in JAX). Returns
    ``(params, aux)``.

    The views come from ``np.random.default_rng(seed)`` as in JAX; each
    event's split noise is ``noise_fn(gen, capacity, device)``, default
    ``train.split_noise``, ``gen`` a ``torch.Generator`` seeded ``seed``
    on the parameters' device. A step whose render overflowed is kept, as
    JAX's loop keeps it (the harness has no retry). ``out``, a dict if
    given, receives the final Adam state (``opt_state``), the number of
    overflowed steps (``overflowed``, read once at the end) and each
    event's counts (``events``)."""
    opt = opt or OptimizationParams(position_lr_max_steps=3000)
    noise_fn = noise_fn or t_train.split_noise
    params, aux = _copy(params, aux)
    opt_state = init_adam(params)
    dev = params.xyz.device
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    overflowed = torch.zeros((), dtype=torch.int64, device=dev)
    events = []
    B = cams.batch_size
    for it in range(start_iter + 1, start_iter + iters + 1):
        v = int(rng.integers(0, B))
        params, aux, opt_state, metrics = t_train.train_step(
            params, aux, opt_state, cams.take(slice(v, v + 1)), bg, it,
            lr_scale, 0.0, rcfg=rcfg, opt=opt, active_sh_degree=0,
            use_exp=False, sparse_adam=False,
            update_stats=it < densify_until)
        overflowed += metrics["overflow"] > 0
        if densify_from < it < densify_until and it % densify_every == 0:
            params, aux, opt_state, info = densify_and_prune(
                params, aux, opt_state, noise_fn(gen, params.capacity, dev),
                opt.densify_grad_threshold, 0.005, extent, 0.0,
                opt.percent_dense)
            events.append(info)
    if out is not None:
        out.update(opt_state=opt_state, overflowed=int(overflowed),
                   events=[{k: int(v) for k, v in e.items()} for e in events])
    return params, aux


@torch.no_grad()
def eval_psnr(params, aux, cams, rcfg, bg) -> float:
    """Mean PSNR over every view of ``cams`` at SH degree 0 (``aux`` is
    unused: the mask is ``params.alive``)."""
    out = batch_render(params, cams, bg, config=rcfg, alive=params.alive,
                       active_sh_degree=0)
    return float(torch.mean(psnr(out.render, cams.gt_image)))


def run_lm(params, aux, cams, rcfg, bg, *, steps, lm=None, seed=2,
           infos=None):
    """LM outer steps over random contiguous windows (the LM phase's
    anatomy), validated on the first ``num_val_views`` views. Returns the
    new parameters (``params`` is not changed); ``infos``, a list if
    given, receives each step's ``(window, info)``."""
    lm = lm or default_lm()
    rng = np.random.default_rng(seed)
    B = cams.batch_size
    val = cams.take([i % B for i in range(lm.num_val_views)])
    for _ in range(steps):
        win = select_window(B, lm.num_images, rng)
        params, info = lm_outer_step(
            params, params.alive, cams.take(win), val, bg, rcfg=rcfg, lm=lm,
            active_sh_degree=0, use_exp=False)
        if infos is not None:
            infos.append((win, info))
    return params


def lm_cost_in_adam_steps(lm=None) -> float:
    """Render-count equivalence: one LM outer step in Adam steps.

    An Adam step is ~1 forward + 1 backward ~ 2.8 forward-equivalents (the
    JAX package's ratio of its forward to its forward + backward). One LM
    outer step with window W, V validation views and k CG iterations:
    the linearization's forward and VJP build (~2.8 W), k · (J·v 2 W +
    Jᵀ·u 2.8 W), and line_search_steps + 1 validation renders of V views
    (a forward each), divided by 2.8."""
    lm = lm or default_lm()
    W, V, k = lm.num_images, lm.num_val_views, lm.cg_max_iter
    fwd_eq = (2.8 * W + k * (2.0 * W + 2.8 * W)
              + (lm.line_search_steps + 1) * V)
    return fwd_eq / 2.8


def launch_counts() -> dict[str, int]:
    """Launches of kernels A, B, C and E in this process so far."""
    return {"A": rasterize_cuda.composite_tiles.launches,
            "B": blur_cuda.blur_same.launches,
            "C": rasterize_cuda.composite_tiles_bwd.launches,
            "E": rasterize_cuda.composite_tiles_jvp.launches}


def device_busy(fn) -> dict:
    """One call of ``fn`` on the card under ``torch.profiler`` (device
    activity only): the CUDA kernels it ran, their summed device time and
    the host wall time around it, in ms (the profiler adds host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"kernels": len(kern), "wall_ms": wall,
            "busy_ms": sum(e.time_range.elapsed_us() for e in kern) / 1e3}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def run_one(seed: int, kw: dict, iters: int, dens_until: int, extra: int,
            lm=None, *, device=None, profile=True) -> dict:
    """One seed: the problem, Adam to the plateau, then ``extra`` Adam steps
    against the LM steps that cost as much. Prints the JAX script's two
    lines and a third with each phase's wall time, the kernel launches of
    each phase, the overflowed steps and the largest tile loads; with
    ``profile``, on the card, a fourth with the kernels and device-busy
    share of one Adam and one LM step from the plateau.

    Returns a dict: ``init``, ``plateau``, ``adam``, ``lm`` (PSNR, dB),
    ``alive``, ``n_lm``, ``overflowed`` (Adam steps, both phases),
    ``seconds`` and ``launches`` per phase (``adam``, ``adam_extra``,
    ``lm``), ``max_tile_load`` (ground truth, plateau), and ``state``,
    the plateau's ``(params, aux, cams, rcfg, bg)``, and ``busy``:
    ``device_busy`` of one Adam step and one LM step from the plateau,
    each after an unprofiled one (None on the CPU or without
    ``profile``)."""
    dev = resolve_device(device)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    lm = lm or default_lm(mask_xyz=False)
    seconds, launches, adam_out, extra_out, built = {}, {}, {}, {}, {}
    t0 = clock()
    params, aux, cams, rcfg, bg = build_problem(seed=seed, **kw, device=dev,
                                                info=built)
    p_init = eval_psnr(params, aux, cams, rcfg, bg)
    seconds["build"] = clock() - t0

    t0, n0 = clock(), launch_counts()
    params, aux = run_adam(params, aux, cams, rcfg, bg, iters=iters,
                           densify_every=100, densify_from=100,
                           densify_until=dens_until, seed=seed + 1,
                           out=adam_out)
    seconds["adam"], launches["adam"] = clock() - t0, _since(n0)
    p_plat = eval_psnr(params, aux, cams, rcfg, bg)
    n_alive = int(params.alive.sum())
    print(f"[seed {seed}] init {p_init:.2f} -> adam@{iters} {p_plat:.3f} dB"
          f"  alive {n_alive}  ({seconds['adam']:.0f}s)", flush=True)

    t0, n0 = clock(), launch_counts()
    pa, aa = run_adam(params, aux, cams, rcfg, bg, iters=extra,
                      start_iter=iters, densify_until=0, seed=seed + 2,
                      out=extra_out)
    seconds["adam_extra"], launches["adam_extra"] = clock() - t0, _since(n0)
    p_adam = eval_psnr(pa, aa, cams, rcfg, bg)

    n_lm = max(1, round(extra / lm_cost_in_adam_steps(lm)))
    t0, n0 = clock(), launch_counts()
    pl_ = run_lm(params, aux, cams, rcfg, bg, steps=n_lm, lm=lm,
                 seed=seed + 3)
    seconds["lm"], launches["lm"] = clock() - t0, _since(n0)
    p_lm = eval_psnr(pl_, aux, cams, rcfg, bg)
    with torch.no_grad():
        plat_load = int(torch.amax(batch_render(
            params, cams, bg, config=rcfg, alive=params.alive,
            active_sh_degree=0).max_tile_load))
    busy = _profile_steps(params, aux, cams, rcfg, bg, iters, lm) \
        if profile and dev.type == "cuda" else None
    overflowed = adam_out["overflowed"] + extra_out["overflowed"]
    print(f"[seed {seed}] plateau {p_plat:.3f}  adam+{extra} {p_adam:.3f} "
          f"(+{p_adam - p_plat:.3f})  lm+{n_lm} {p_lm:.3f} "
          f"(+{p_lm - p_plat:.3f})", flush=True)
    print(f"[seed {seed}] wall (s): build {seconds['build']:.2f}, "
          f"adam@{iters} {seconds['adam']:.2f}, adam+{extra} "
          f"{seconds['adam_extra']:.2f}, lm+{n_lm} {seconds['lm']:.2f}; "
          f"launches adam@{iters} {launches['adam']}, adam+{extra} "
          f"{launches['adam_extra']}, lm+{n_lm} {launches['lm']}; "
          f"overflowed steps {overflowed}; records per tile at most "
          f"{built['gt_max_tile_load']} (ground truth), {plat_load} "
          f"(plateau)", flush=True)
    if busy:
        print(f"[seed {seed}] one step from the plateau under the profiler: "
              + "; ".join(f"{k} {b['kernels']} CUDA kernels, device busy "
                          f"{b['busy_ms']:.3f} ms of {b['wall_ms']:.3f} ms "
                          f"wall ({b['busy_ms'] / b['wall_ms']:.3f})"
                          for k, b in busy.items()), flush=True)
    return dict(busy=busy, init=p_init, plateau=p_plat, adam=p_adam, lm=p_lm,
                alive=n_alive, n_lm=n_lm, overflowed=overflowed,
                seconds=seconds, launches=launches,
                max_tile_load=(built["gt_max_tile_load"], plat_load),
                state=(params, aux, cams, rcfg, bg))


def _profile_steps(params, aux, cams, rcfg, bg, iters: int, lm) -> dict:
    """``device_busy`` of one Adam step (on copies, view 0) and one LM step
    (the first window) from the plateau, each after an unprofiled one."""
    p, a = _copy(params, aux)
    state = init_adam(p)
    cam = cams.take(slice(0, 1))
    opt = OptimizationParams(position_lr_max_steps=3000)
    window = cams.take(list(range(min(lm.num_images, cams.batch_size))))
    val = cams.take([i % cams.batch_size for i in range(lm.num_val_views)])

    def adam():
        t_train.train_step(p, a, state, cam, bg, iters + 1, 1.5, 0.0,
                           rcfg=rcfg, opt=opt, active_sh_degree=0,
                           use_exp=False, sparse_adam=False,
                           update_stats=False)

    def lm_step():
        lm_outer_step(params, params.alive, window, val, bg, rcfg=rcfg,
                      lm=lm, active_sh_degree=0, use_exp=False)

    out = {}
    for name, fn in (("Adam step", adam), ("LM step", lm_step)):
        fn()
        out[name] = device_busy(fn)
    return out


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="LM vs Adam at equal render budget")
    size = parser.add_mutually_exclusive_group()
    size.add_argument("--small", action="store_true")
    size.add_argument("--large", action="store_true")
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--win", type=int, default=None)
    parser.add_argument("--cg", type=int, default=None)
    parser.add_argument("--ls", type=int, default=None)
    parser.add_argument("--platform", type=str, default="")
    return parser


def main(argv=None) -> list[dict]:
    """The command line (``argv``, default ``sys.argv[1:]``): ``--seeds``
    runs of ``run_one`` at the chosen size, then the summary over the
    seeds. Returns ``run_one``'s dicts."""
    args = build_parser().parse_args(argv)
    dev = platform_device(args.platform)
    lm = None
    if any(v is not None for v in (args.win, args.cg, args.ls)):
        # the JAX script's full-window settings: 8 views and validation
        # views, CG 4, unless given
        lm = LMParams(num_images=args.win or 8, num_val_views=8,
                      val_view_stride=1, cg_max_iter=args.cg or 4,
                      cg_restart_iter=1, line_search_steps=(
                          6 if args.ls is None else args.ls),
                      mask_xyz=False)
        print(f"LM settings: window {lm.num_images} / cg {lm.cg_max_iter} "
              f"/ ls {lm.line_search_steps}")
    size = SIZES["small" if args.small else "large" if args.large
                 else "default"]
    rows = [run_one(s, size["kw"], size["iters"], size["dens_until"],
                    size["extra"], lm=lm, device=dev)
            for s in range(args.seeds)]
    plat, adam, lm_ = (np.array([r[k] for r in rows])
                       for k in ("plateau", "adam", "lm"))
    d_adam, d_lm = adam - plat, lm_ - plat
    print(f"\n=== {args.seeds} seeds, scene {size['kw']} ===")
    print(f"plateau      {plat.mean():.3f} ± {plat.std():.3f} dB")
    print(f"adam delta  +{d_adam.mean():.3f} ± {d_adam.std():.3f} dB")
    print(f"lm delta    +{d_lm.mean():.3f} ± {d_lm.std():.3f} dB")
    print(f"lm - adam   {(d_lm - d_adam).mean():+.3f} "
          f"± {(d_lm - d_adam).std():.3f} dB", flush=True)
    return rows


if __name__ == "__main__":
    main()
