"""Kernel A (``csrc/composite_fwd.cu``) against other builds of it on one
card: bit for bit, timed in turns, registers and SASS.

    python3 compare_fwd.py NAME=FILE.cu [NAME=FILE.cu ...] [--sass-dir DIR]

Each FILE is a kernel A source with the C entry point ``composite_fwd`` and
the template ``composite_fwd_kernel<bool RECT>``: an earlier design
(``git show <commit>:gslm_tpu_torch/csrc/composite_fwd.cu > build/old.cu``;
``build/`` is git-ignored) or a variant of this one. nvcc builds each, with
``csrc/composite_fwd_attrs.cuh`` appended, beside the package's kernels,
all at once. On the inputs of kernel A's four timed shapes in
``chip_smoke.py`` -- the 4-view serving stack, the training view, the LM
window (the scenes before any step) and m1 at bucket 4 with rects -- every
build's rows 0-6 and ``walked`` must equal the package kernel's bit for
bit; then all are timed in turns (CUDA events, the order reversed every
round, one untimed round first; median of ``ROUNDS`` each). Prints every
build's registers, static shared memory and resident 256-thread blocks per
SM and its SASS totals; with ``--sass-dir``, writes each build's SASS there
in basic blocks with opcode counts, where ``chip_smoke.py``'s per-pair
counts ``A_*`` are read. Exits non-zero if a build fails or differs.

Imports nothing of JAX or of gslm_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import numpy as np

import chip_smoke as cs

ROUNDS = 10   # timed rounds in turns per shape


def start_build(name: str, src: str):
    """Start nvcc on ``src`` (composite_fwd_attrs.cuh appended); returns
    (name, process, library path)."""
    from gslm_tpu_torch import _build
    out_dir = _build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(src) as f:
        text = f.read()
    if "composite_fwd_attrs.cuh" not in text:
        text += '\n#include "composite_fwd_attrs.cuh"\n'
    cu = out_dir / f"composite_fwd_{name}.cu"
    cu.write_text(text)
    lib = out_dir / f"composite_fwd_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(lib), str(cu)]
    return name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True), lib


def finish_build(name: str, proc, lib) -> ctypes.CDLL:
    from gslm_tpu_torch import _build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for kernel A ({name}):\n{log}")
    cdll = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.SIGNATURES["composite_fwd"].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def caller(lib):
    """``composite_tiles`` through the kernel A of ``lib``."""
    import torch

    from gslm_tpu_torch import _build
    from gslm_tpu_torch.ops.rasterize_cuda import OUT_ROWS, PIX

    def call(records, starts, counts, ntx, view_rows, rects=None):
        ntiles = counts.shape[0]
        out = torch.empty(ntiles, OUT_ROWS, PIX, device=records.device)
        walked = torch.empty(ntiles, dtype=torch.int32,
                             device=records.device)
        _build.check(lib.composite_fwd(
            records.data_ptr(), None if rects is None else rects.data_ptr(),
            starts.data_ptr(), counts.data_ptr(), ntiles, ntx, view_rows,
            out.data_ptr(), walked.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "composite_fwd")
        return out, walked
    return call


def compare(label: str, calls: dict, records, starts, counts, ntx: int,
            view_rows: int, rects=None) -> None:
    """Every build of ``calls`` ({name: call}) bit for bit against the
    package's kernel A on these inputs, then all timed in turns."""
    import torch

    from gslm_tpu_torch.ops.rasterize_cuda import composite_tiles
    args = (records, starts, counts, ntx, view_rows, rects)
    want, want_walked = composite_tiles(*args)
    for name, call in calls.items():
        got, walked = call(*args)
        cs.check(torch.equal(got, want) and torch.equal(walked, want_walked),
                 f"kernel A ({name}) differs from the package's on {label}")
        del got, walked
    del want, want_walked
    fns = {"package": lambda: composite_tiles(*args),
           **{k: (lambda c=c: c(*args)) for k, c in calls.items()}}
    times = {k: [] for k in fns}
    for r in range(ROUNDS + 1):
        for k in (list(fns) if r % 2 else list(fns)[::-1]):
            ms = cs.cuda_times(fns[k], 1, warmup=0)[0]
            if r:
                times[k].append(ms)
    print(f"kernel A {label} ({records.shape[0]} records): rows 0-6 and "
          f"walked of {sorted(calls)} bitwise equal to the package's; in "
          f"turns, median of {ROUNDS} (ms): "
          + ", ".join(f"{k} {statistics.median(v):.4f}"
                      for k, v in times.items())
          + "; runs " + ", ".join(f"{k} {[round(x, 4) for x in v]}"
                                  for k, v in times.items()), flush=True)


def shapes(dev):
    """Yield (label, records, starts, counts, ntx, view_rows, rects) for
    kernel A's four timed shapes in chip_smoke.py, one at a time."""
    from gslm_tpu_torch.config import LMParams
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig, _cdiv
    from gslm_tpu_torch.renderer import stack_views
    from gslm_tpu_torch.train_lm import select_window
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)
    ntx, nty = _cdiv(cs.W, 16), _cdiv(cs.H, 16)

    def scene(seed: int, n: int, **kw):
        return random_gaussians(np.random.default_rng(seed), n=n, capacity=n,
                                sh_degree=3, spread=1.5,
                                scale_range=(-5.5, -3.5), device=dev, **kw)

    def records(params, cams, caps, views=1):
        cfg = RasterConfig(**caps)
        splats = stack_views(params, cams, config=cfg)[0]
        return rc.tile_records(splats, ntx, views * nty, cfg, nty)[:3]

    cams = ring_camera_batch(cs.VIEWS, cs.H, cs.W, device=dev)
    yield (f"({cs.VIEWS}-view stack)",
           *records(scene(0, cs.N_GAUSS), cams, cs.CAPS, cs.VIEWS), ntx, nty,
           None)
    p50 = scene(0, cs.N_GAUSS, num_images=cs.EXPOSURES)
    cam = ring_camera_batch(1, cs.H, cs.W, device=dev)
    yield ("(training view)", *records(p50, cam, cs.TRAIN_CAPS), ntx, nty,
           None)
    win = select_window(cs.EXPOSURES, LMParams().num_images,
                        np.random.default_rng(0))
    window = ring_camera_batch(cs.EXPOSURES, cs.H, cs.W, gt_seed=None,
                               device=dev).take(win)
    yield ("(LM window)", *records(p50, window, cs.LM_CAPS, len(win)), ntx,
           nty, None)
    del p50
    cfg = RasterConfig(**cs.M1_CAPS)
    splats = stack_views(scene(2, cs.M1_N, num_images=1), cam, config=cfg)[0]
    tr = rc.tile_records(splats, ntx, nty, cfg)
    yield ("(m1 bucket 4)", tr.records, tr.starts, tr.counts, ntx, nty,
           tr.buckets.rects)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=FILE.cu",
                    help="kernel A sources to hold against the package's")
    ap.add_argument("--sass-dir", metavar="DIR",
                    help="write every build's SASS there in basic blocks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_fwd: CUDA is not available", file=sys.stderr)
        return 1
    from gslm_tpu_torch import _build
    print(f"card: {cs.card_line()}", flush=True)
    started = [start_build(*b.split("=", 1)) for b in args.builds]
    _build.build_all()
    libs = {"package": _build.load("composite_fwd"),
            **{name: finish_build(name, proc, lib)
               for name, proc, lib in started}}
    for name, lib in libs.items():
        print(f"kernel A ({name}) registers, static shared bytes, resident "
              f"256-thread blocks per SM: {cs.fwd_attrs(lib)}", flush=True)
    cs.sass_totals({f"composite_fwd_{k}": lib._name
                    for k, lib in libs.items()}, args.sass_dir)
    calls = {k: caller(lib) for k, lib in libs.items() if k != "package"}
    with torch.no_grad():
        for label, *inputs in shapes(torch.device("cuda")):
            compare(label, calls, *inputs)
            del inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
