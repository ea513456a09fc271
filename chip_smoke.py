"""On-card smoke run of gslm_tpu_torch, the PyTorch/CUDA port (one H100).

    python3 chip_smoke.py

Drives the port's serving path (render a batch of views, score them) at
full width and checks it, in phases; any failed phase exits non-zero:

1. card and build: the card's name and power limit; nvcc builds every
   kernel of ``gslm_tpu_torch/csrc`` (one process per source, in parallel).
2. each kernel against its plain PyTorch version on the card: kernel A
   (tile compositor) on one 1920x1080 view of the headline scene, kernel B
   (SSIM blur) on (15, 1080, 1920) planes. TF32 is off for matmul and cuDNN.
3. main path: ``batch_render`` of the 131,072-Gaussian SH-3 scene
   (spread 1.5, log-scales in [-5.5, -3.5], seed 0) in a 4-view 1920x1080
   batch, then ``pair_metrics`` of every view against its ground truth.
   Checks: no overflow, finite images, kernel A launched once and kernel B
   once per pair, every batched view equal bit for bit to its single-view
   render, kernel A against its plain version on the main path's own
   4-view stack (tile rows wrapping per view), and the kernel path against
   the dense golden rasterizer on a small scene.
4. timings (CUDA events, median after warm-up), stage breakdown, records
   walked, kernel A's pairs by gate outcome and each kernel's bound.
5. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of gslm_tpu. Without CUDA it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_GAUSS, H, W, VIEWS = 131_072, 1080, 1920, 4
# bench.py's single-view capacities, scaled to the 4-view stack
CAPS = dict(dup_capacity=VIEWS * 1_638_400, live_capacity=VIEWS * 1_280_000,
            cull=True)
PEAK_FP32 = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
# Issue rates behind PEAK_FP32 (an FMA counts two FLOPs): 128 fp32 lanes
# per SM per clock, each taking one FFMA, FADD or FMUL; the SFU (MUFU) has
# 16 lanes per SM per clock.
FP32_RATE = PEAK_FP32 / 2      # fp32 lane instructions/s
MUFU_RATE = FP32_RATE / 8      # MUFU lane instructions/s
# Kernel A's lane instructions per (record, pixel) pair, by how far the pair
# gets, as (FFMA+FADD+FMUL, MUFU), counted in the SASS of
# csrc/composite_fwd.cu (nvcc 12.9, sm_90a, `cuobjdump -sass`):
A_EVAL = (9, 0)       # dx, dy, power, then the power > 0 gate
A_EXP = (7, 1)        # past it: expf (one MUFU.EX2), opacity, the 0.99 clip
A_CONTRIB = (23, 1)   # past the 1/255 gate: log1pf (16), lsum, expf
A_ACC = (5, 0)        # T_after >= 1e-4: weight and four accumulators


def check(cond, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_times(fn, reps: int, warmup: int = 1) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn`` between CUDA events,
    after ``warmup`` untimed calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    return statistics.median(cuda_times(fn, reps, warmup))


def device_busy(fn) -> tuple[int, float, float]:
    """One profiled call of ``fn``: (CUDA kernels launched, their summed
    device time in ms, host wall time in ms, profiler overhead included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return len(kernels), busy, wall


def knife_edge_ok(got, want) -> tuple[bool, float]:
    """The random-scene bound of the parity tests: mean |Δ| < 2e-4 and at
    most 1% of values with |Δ| > 1e-3. Returns (ok, max |Δ|)."""
    d = (got - want).abs()
    ok = float(d.mean()) < 2e-4 and float((d > 1e-3).float().mean()) <= 0.01
    return ok, float(d.max())


def pair_work(records, starts, counts, ntx: int, view_rows: int,
              max_elems: int = 1 << 25) -> list[int]:
    """Kernel A's (record, pixel) pairs on these inputs by how far each
    gets, from the plain arithmetic: [evaluated (the pixel has not exited),
    past the power gate, past the 1/255 gate, accumulated (T_after >=
    1e-4)]."""
    import torch

    from gslm_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN, T_EPS
    from gslm_tpu_torch.ops.rasterize_cuda import PIX, _tile_pixels
    dev = records.device
    ntiles = counts.shape[0]
    S = max(int(counts.max()), 1)
    G = max(1, max_elems // (S * PIX))
    slot = torch.arange(S, device=dev)
    n = torch.zeros(4, dtype=torch.long, device=dev)
    for t0 in range(0, ntiles, G):
        tiles = torch.arange(t0, min(t0 + G, ntiles), device=dev)
        valid = (slot[None] < counts[tiles, None])[..., None]    # (G, S, 1)
        idx = torch.clamp(starts[tiles, None].long() + slot[None], 0,
                          records.shape[0] - 1)
        rec = records[idx]
        px, py = _tile_pixels(tiles, ntx, view_rows)
        dx = rec[..., 0, None] - px[:, None]                      # (G, S, 256)
        dy = rec[..., 1, None] - py[:, None]
        power = (-0.5 * (rec[..., 2, None] * dx * dx
                         + rec[..., 4, None] * dy * dy)
                 - rec[..., 3, None] * dx * dy)
        past_exp = valid & (power <= 0.0)
        alpha = torch.clamp(
            rec[..., 5, None] * torch.exp(torch.where(past_exp, power, -100.0)),
            max=ALPHA_MAX)
        past_con = past_exp & (alpha >= ALPHA_MIN)
        t_after = torch.exp(torch.cumsum(
            torch.log1p(-torch.where(past_con, alpha, 0.0)), dim=1))
        fail = (past_con & (t_after < T_EPS)).int()
        live = (torch.cumsum(fail, dim=1) - fail) == 0
        n += torch.stack([(valid & live).sum(), (past_exp & live).sum(),
                          (past_con & live).sum(),
                          (past_con & live & (fail == 0)).sum()])
    return [int(v) for v in n.tolist()]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    run(torch.device("cuda"), N_GAUSS, H, W)
    return 0


def run(dev, n_gauss: int, height: int, width: int) -> None:
    """All phases on ``dev`` for an n_gauss scene at height x width."""
    import torch

    from gslm_tpu_torch import _build
    from gslm_tpu_torch.eval.metrics import pair_metrics
    from gslm_tpu_torch.ops.blur_cuda import blur_plain, blur_same
    from gslm_tpu_torch.ops.projection import preprocess
    from gslm_tpu_torch.ops.rasterize_cuda import (composite_tiles,
                                                   composite_tiles_plain,
                                                   tile_records)
    from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                    _cell_masks,
                                                    duplicate_sort_ranges)
    from gslm_tpu_torch.ops.ssim import gaussian_taps
    from gslm_tpu_torch.renderer import batch_render, render, stack_views
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    tag = f"[{card}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (the library yardstick conv runs "
          "in full fp32)", flush=True)
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(_build.SIGNATURES)} kernels in parallel)", flush=True)

    params = random_gaussians(np.random.default_rng(0), n=n_gauss,
                              capacity=n_gauss, sh_degree=3, spread=1.5,
                              scale_range=(-5.5, -3.5), device=dev)
    cams = ring_camera_batch(VIEWS, height, width, device=dev)
    cfg = RasterConfig(**CAPS)
    bg = torch.zeros(3, device=dev)
    ntx, nty = _cdiv(width, 16), _cdiv(height, 16)
    taps = gaussian_taps()
    err = {}

    with torch.no_grad():
        # ---- 2. kernels against their plain versions ---------------------
        sp0 = preprocess(params, cams.view(0), active_sh_degree=3,
                         alive=params.alive)
        rec0, st0, cn0, _ = tile_records(sp0, ntx, nty, cfg)
        got, walked0 = composite_tiles(rec0, st0, cn0, ntx, nty)
        want, _ = composite_tiles_plain(rec0, st0, cn0, ntx, nty)
        torch.cuda.synchronize()
        ok, e = knife_edge_ok(got, want)
        print(f"kernel A vs plain (1 view, {rec0.shape[0]} records): "
              f"max|d| {e:.3g}", flush=True)
        check(ok, "kernel A disagrees with composite_tiles_plain")
        check(bool((walked0 <= cn0).all()), "kernel A walked past a segment")

        planes = torch.rand(15, height, width, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
        got = blur_same(planes, taps)
        want = blur_plain(planes, taps)
        torch.cuda.synchronize()
        err["B"] = float((got - want).abs().max())
        print(f"kernel B vs plain {tuple(planes.shape)}: max|d| {err['B']:.3g}",
              flush=True)
        check(err["B"] <= 1e-6, "kernel B disagrees with blur_plain")

        # ---- 3. main path at full width ----------------------------------
        composite_tiles.launches = 0
        blur_same.launches = 0
        out = batch_render(params, cams, bg, config=cfg)
        metrics = [pair_metrics(out.render[v], cams.gt_image[v])
                   for v in range(VIEWS)]
        torch.cuda.synchronize()
        launches = {"A": composite_tiles.launches, "B": blur_same.launches}
        print(f"main path launches: {launches}", flush=True)
        check(launches == {"A": 1, "B": VIEWS},
              f"main path launches {launches}: expected A once per "
              f"batch_render and B once per pair")
        check(int(out.overflow) == 0, f"overflow (n_duplicates "
              f"{int(out.n_duplicates)})")
        check(out.render.shape == (VIEWS, 3, height, width), "render shape")
        check(bool(torch.isfinite(out.render).all())
              and bool(torch.isfinite(out.invdepth).all()), "finite images")
        ssims = [float(s) for s, _ in metrics]
        psnrs = [float(p) for _, p in metrics]
        check(all(np.isfinite(ssims + psnrs)) and all(-1 <= s <= 1
                                                      for s in ssims),
              "metrics finite")
        print(f"main path: n_duplicates {int(out.n_duplicates)}, "
              f"max_tile_load {int(out.max_tile_load)}, visible/view "
              f"{[int(v.sum()) for v in out.visibility]}, mean "
              f"{float(out.render.mean()):.5f}, SSIM {ssims}, PSNR {psnrs}",
              flush=True)
        for v in range(VIEWS):
            one = render(params, cams.view(v), bg, config=cfg)
            check(torch.equal(one.render, out.render[v])
                  and torch.equal(one.invdepth, out.invdepth[v]),
                  f"batched view {v} differs from the single-view render")
        print(f"batched views 0-{VIEWS - 1} == single-view renders: bitwise",
              flush=True)

        # kernel A against its plain version on the main path's own inputs:
        # the 4-view stack, where tile rows wrap modulo view_rows
        splats, _, _ = stack_views(params, cams, config=cfg)
        rec, st, cn, _ = tile_records(splats, ntx, VIEWS * nty, cfg, nty)
        got, walked = composite_tiles(rec, st, cn, ntx, nty)
        want, _ = composite_tiles_plain(rec, st, cn, ntx, nty)
        torch.cuda.synchronize()
        ok, err["A"] = knife_edge_ok(got, want)
        print(f"kernel A vs plain ({VIEWS}-view stack, {cn.shape[0]} tiles, "
              f"{rec.shape[0]} records): max|d| {err['A']:.3g}", flush=True)
        check(ok, "kernel A disagrees with composite_tiles_plain on the stack")
        check(bool((walked <= cn).all()), "kernel A walked past a segment")

        small = random_gaussians(np.random.default_rng(1), n=2048,
                                 spread=1.5, device=dev)
        scams = ring_camera_batch(1, 72, 96, device=dev)
        ok, e = knife_edge_ok(
            batch_render(small, scams, bg, config=cfg).render,
            batch_render(small, scams, bg, config=cfg, impl="ref").render)
        print(f"small scene vs dense golden rasterizer: max|d| {e:.3g}",
              flush=True)
        check(ok, "kernel path disagrees with rasterize_ref")

        # ---- 4. timings --------------------------------------------------
        br_times = cuda_times(
            lambda: batch_render(params, cams, bg, config=cfg), 5)
        br_ms = statistics.median(br_times)
        n_kern, busy_ms, wall_ms = device_busy(
            lambda: batch_render(params, cams, bg, config=cfg))
        pm_ms = cuda_ms(lambda: pair_metrics(out.render[0], cams.gt_image[0]),
                        10)
        cwb = max(_cdiv(ntx, 8).bit_length(), 1)
        stage = {
            "preprocess+stack": cuda_ms(
                lambda: stack_views(params, cams, config=cfg), 3),
            "cell masks": cuda_ms(lambda: _cell_masks(splats, nty, cwb), 3),
            "duplicate+sort+ranges (incl. cell masks)": cuda_ms(
                lambda: duplicate_sort_ranges(
                    splats, ntx, VIEWS * nty, cfg.dup_capacity,
                    view_rows=nty, cull=True,
                    live_capacity=cfg.live_capacity), 3),
            "tile_records (incl. the above + record gather)": cuda_ms(
                lambda: tile_records(splats, ntx, VIEWS * nty, cfg, nty), 3),
            "kernel A": cuda_ms(
                lambda: composite_tiles(rec, st, cn, ntx, nty), 10),
        }
        a_plain_ms = cuda_ms(
            lambda: composite_tiles_plain(rec, st, cn, ntx, nty), 2)
        n_walked = int(walked.long().sum())
        ntiles = cn.shape[0]
        work = pair_work(rec, st, cn, ntx, nty)
        a_fp32, a_mufu = (sum(n * c[i] for n, c in zip(
            work, (A_EVAL, A_EXP, A_CONTRIB, A_ACC))) for i in (0, 1))
        # records walked, starts + counts in, rgb/invdepth/t_final + walked out
        a_bytes = n_walked * 40 + ntiles * (5 * 256 * 4 + 12)
        a_times = {"fp32 issue": a_fp32 / FP32_RATE,
                   "MUFU issue": a_mufu / MUFU_RATE,
                   "bytes": a_bytes / PEAK_BYTES}
        a_bound = max(a_times.values()) * 1e3
        print(f"{tag} kernel A pairs [evaluated, past power gate, past 1/255 "
              f"gate, accumulated] {work}: {a_fp32} fp32 + {a_mufu} MUFU lane "
              f"instructions, {a_bytes} B; bound ms "
              + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in a_times.items()),
              flush=True)
        print(f"{tag} batch_render {VIEWS}x{width}x{height}: {br_ms:.3f} ms median "
              f"of 5 (runs {[round(t, 3) for t in br_times]}); pair_metrics "
              f"1 pair: {pm_ms:.3f} ms median of 10", flush=True)
        print(f"{tag} batch_render profiled once: {n_kern} CUDA kernels, "
              f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
              f"({busy_ms / wall_ms:.3f}; the profiler adds host time)",
              flush=True)
        print(f"{tag} batch_render stages (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()),
              flush=True)
        print(f"{tag} kernel A: {rec.shape[0]} records in segments, "
              f"{n_walked} walked ({n_walked / max(rec.shape[0], 1):.3f}), "
              f"{n_walked * 256} (record, pixel) pairs; {stage['kernel A']:.3f}"
              f" ms vs bound {a_bound:.3f} ms; plain {a_plain_ms:.3f} ms",
              flush=True)

        b_ms = cuda_ms(lambda: blur_same(planes, taps), 20)
        b_plain_ms = cuda_ms(lambda: blur_plain(planes, taps), 5)
        kh = torch.tensor(taps, device=dev).reshape(1, 1, -1, 1).repeat(
            15, 1, 1, 1)
        kw = kh.reshape(15, 1, 1, -1)
        lib = planes[None]

        def conv_blur():
            x = torch.nn.functional.conv2d(lib, kh, padding=(5, 0), groups=15)
            return torch.nn.functional.conv2d(x, kw, padding=(0, 5), groups=15)

        b_lib_err = float((conv_blur()[0] - blur_same(planes, taps)).abs().max())
        b_lib_ms = cuda_ms(conv_blur, 20)
        b_bytes = 2 * planes.numel() * 4
        # one FMUL and one FADD per tap per pass (no FMA: tap-order sums)
        b_ops = 2 * 2 * len(taps) * planes.numel()
        b_bound = max(b_bytes / PEAK_BYTES, b_ops / FP32_RATE) * 1e3
        print(f"{tag} kernel B {tuple(planes.shape)}: {b_ms:.4f} ms vs bound "
              f"{b_bound:.4f} ms; plain {b_plain_ms:.4f} ms; conv2d "
              f"depthwise (TF32 off) {b_lib_ms:.4f} ms, max|d| {b_lib_err:.3g}",
              flush=True)

    kernels = [
        {"name": "composite_fwd", "route": "cuda",
         "source": "gslm_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "gslm_tpu/ops/rasterize_pallas.py:440",
         "launches": launches["A"], "max_abs_err": err["A"],
         "ms": stage["kernel A"], "plain_ms": a_plain_ms,
         "bound_ms": a_bound,
         "bound_by": "bytes" if a_bound == a_times["bytes"] * 1e3
         else "operations", "library_ms": None},
        {"name": "blur_same", "route": "cuda",
         "source": "gslm_tpu_torch/csrc/blur.cu",
         "replaces": "gslm_tpu/ops/blur_pallas.py:87",
         "launches": launches["B"], "max_abs_err": err["B"],
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": "bytes" if b_bytes / PEAK_BYTES >= b_ops / FP32_RATE
         else "operations", "library_ms": b_lib_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
