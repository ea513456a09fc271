"""Kernels A, B, C, D and E against other builds of them on one card:
held to the package's kernel, timed in turns, registers and SASS.

    python3 compare_kernels.py KERNEL NAME=FILE.cu [NAME=FILE.cu ...]
                               [--sass-dir DIR]

KERNEL is A (``csrc/composite_fwd.cu``, the forward compositor), B
(``csrc/blur.cu``, the SSIM blur), C (``csrc/composite_bwd.cu``, the
compositor's backward), D (``csrc/composite_bucket_bwd.cu``, the bucket
backward) or E (``csrc/composite_jvp.cu``, the forward + tangent
compositor). Each FILE is a source of that kernel with the same C entry
point: an earlier design or a variant of this one. Kernel D's entry took
no scratch before its walk-and-sum design, whose library also exports
``composite_bucket_bwd_unmasked``: a build without that symbol is called
with the earlier arguments. The headers beside FILE come before the
package's, so an earlier design builds with its own (``git archive
<commit> gslm_tpu_torch/csrc | tar -x -C build/compare/old``, then
``old=build/compare/old/gslm_tpu_torch/csrc/composite_bwd.cu``;
``build/`` is git-ignored). nvcc builds each (``-Xptxas -v``; kernel A's
sources get ``csrc/composite_fwd_attrs.cuh`` appended) beside the
package's kernels, all at once. For C the script also builds
``premasked``, the package's source with each record's patch mask read
from memory instead of computed (the mask ``patch_masks`` computes, one
byte per record: the saved-mask design). On the inputs of the kernel's
timed shapes in ``chip_smoke.py`` (the scenes before any step) every build
is held to the package's kernel:

- A (the 4-view serving stack, the training view, the LM window, m1 at
  bucket 4 with rects): rows 0-6 and ``walked`` bit for bit;
- C (the training view with depth_grad, the LM window without, m1 at bucket
  1 with; a seeded image cotangent, kernel A's exit state): every field
  within 2e-6 of the build's own max |value| (another summation order),
  and whether bit for bit is printed; the package's guard C<MASK=false> is
  timed beside them (``guard``);
- D (m1 at bucket 4, depth_grad; a seeded image cotangent, kernel A's exit
  state): the same as C, the package's guard D<MASK=false> timed beside
  them (``guard``), and the package's walk and sum timed apart;
- B (the 15 SSIM planes of the training view against its target, and of
  one served view against its ground truth, (15, 1080, 1920)): every build
  ``torch.equal`` to the package's and to ``blur_plain``, with the SSIM
  taps and with them reversed (the VJP's);
- E (the LM window, m1 at bucket 4 with rects; a seeded tangent scaled per
  field): primal rows 0-6 bit for bit, tangent rows within 1e-6 of the
  build's max |value| per row (bit for bit printed); the package's guard
  E<MASK=false> is timed beside them (``guard``).

Then all are timed in turns (CUDA events, the order reversed every round,
one untimed round first; median of ``ROUNDS`` each). Prints every build's
ptxas registers and shared memory per kernel function, the package's
``*_attrs`` (registers, static shared memory, resident 256-thread blocks per
SM) and every build's SASS totals; with ``--sass-dir``, writes each build's
SASS there in basic blocks with opcode counts, where ``chip_smoke.py``'s
per-pair counts (``A_*``, ``C_*``, ``E_*``) are read. Exits non-zero if a
build fails or is not held.

Imports nothing of JAX or of gslm_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROUNDS = 10   # timed rounds in turns per shape
LIBS = {"A": "composite_fwd", "B": "blur", "C": "composite_bwd",
        "D": "composite_bucket_bwd", "E": "composite_jvp"}
# kernel D's entry before its walk-and-sum design: no scratch arguments
D_NO_SCRATCH = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
C_TOL = 2e-6   # C: max |build - package| per field, relative
E_TOL = 1e-6   # E's tangent: the same per row


# the saved-mask variant of kernel C: each record's mask from ``g_masks``,
# a patch of kernel C's walk (composite_bwd_tile.cuh)
PREMASKED_PATCH = (
    ('#include "composite_patch.cuh"\n',
     '#include "composite_patch.cuh"\n\n'
     '__constant__ const unsigned char* g_masks;   // (L,) patch masks\n'),
    ("&& (!MASK || patch_bit(geo, f2.x, f2.y, txc, tyc, p));",
     "&& (!MASK || ((g_masks[start + lo + j] >> p) & 1u));"))
PREMASKED_SETTER = """
extern "C" int composite_bwd_set_masks(const unsigned char* masks) {
  return (int)cudaMemcpyToSymbol(g_masks, &masks, sizeof(masks));
}
"""


def premasked_source(out_dir) -> str:
    """Kernel C's source with the patch masks read from memory: its walk's
    header patched and the package's composite_bwd.cu with a setter,
    written to ``out_dir``/premasked (the header beside the source comes
    first in its build); returns the source's path."""
    from gslm_tpu_torch import _build
    text = (_build.CSRC / "composite_bwd_tile.cuh").read_text()
    for old, new in PREMASKED_PATCH:
        if text.count(old) != 1:
            raise RuntimeError(f"premasked: {old!r} not found once in "
                               f"composite_bwd_tile.cuh")
        text = text.replace(old, new)
    d = out_dir / "premasked"
    d.mkdir(parents=True, exist_ok=True)
    (d / "composite_bwd_tile.cuh").write_text(text)
    src = d / "composite_bwd.cu"
    src.write_text((_build.CSRC / "composite_bwd.cu").read_text()
                   + PREMASKED_SETTER)
    return str(src)


def start_build(kernel: str, name: str, src: str):
    """Start nvcc on ``src`` (the headers beside it first); returns (name,
    process, library path)."""
    from gslm_tpu_torch import _build
    lib = LIBS[kernel]
    out_dir = _build.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(src) as f:
        text = f.read()
    if kernel == "A" and "composite_fwd_attrs.cuh" not in text:
        text += '\n#include "composite_fwd_attrs.cuh"\n'
    cu = out_dir / f"{lib}_{name}.cu"
    cu.write_text(text)
    so = out_dir / f"{lib}_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           os.path.dirname(os.path.abspath(src)), "-I", str(_build.CSRC),
           "-o", str(so), str(cu)]
    return name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True), so


def finish_build(kernel: str, name: str, proc, so) -> ctypes.CDLL:
    """The built library, its entry points typed; prints ptxas's registers
    and shared memory per kernel function."""
    from gslm_tpu_torch import _build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for kernel {kernel} ({name}):\n{log}")
    print_ptxas(kernel, name, log)
    cdll = ctypes.CDLL(str(so))
    sigs = dict(_build.SIGNATURES[LIBS[kernel]],
                composite_bwd_set_masks=[ctypes.c_void_p])
    if kernel == "D" and not hasattr(cdll, "composite_bucket_bwd_unmasked"):
        sigs["composite_bucket_bwd"] = D_NO_SCRATCH
    for fn, argtypes in sigs.items():
        if hasattr(cdll, fn):
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
    return cdll


def print_ptxas(kernel: str, name: str, log: str) -> None:
    fn, spill = None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = re.sub(r"^.*?_cu_[0-9a-f]+\d+", "", m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and fn:
            print(f"kernel {kernel} ({name}) ptxas {fn}: {m.group(1)} "
                  f"registers, {m.group(2)} B shared, spill stores/loads "
                  f"{spill} B", flush=True)


def a_call(lib):
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


def c_call(lib, fn: str = "composite_bwd"):
    """``composite_tiles_bwd`` through the kernel C entry ``fn`` of
    ``lib``."""
    import torch

    from gslm_tpu_torch import _build

    def call(records, starts, counts, ntx, view_rows, gtiles, state,
             depth_grad):
        drec = torch.empty_like(records)
        _build.check(getattr(lib, fn)(
            records.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            counts.shape[0], ntx, view_rows, gtiles.data_ptr(),
            state.data_ptr(), int(depth_grad), drec.data_ptr(),
            torch.cuda.current_stream().cuda_stream), fn)
        return drec
    return call


def d_call(lib, fn: str = "composite_bucket_bwd"):
    """``composite_tiles_bucket_bwd`` through the kernel D entry ``fn`` of
    ``lib``, with the scratch it takes (none before the walk-and-sum
    design)."""
    import torch

    from gslm_tpu_torch import _build
    from gslm_tpu_torch.ops.rasterize_cuda import BUCKET_SLOTS, NF
    scratch = hasattr(lib, "composite_bucket_bwd_unmasked")

    def call(records, buckets, ntx, view_rows, gtiles, state, depth_grad):
        n, bk = records.shape[0], buckets.bucket
        drec = torch.empty_like(records)
        ntiles = gtiles.shape[0]
        geometry = (buckets.bcounts.shape[0], *((n,) if scratch else ()),
                    ntx, ntiles // ntx, view_rows, bk)
        extra = ()
        if scratch:
            part = torch.empty(bk * bk, n, NF, device=records.device)
            flags = torch.empty(n, BUCKET_SLOTS, dtype=torch.uint8,
                                device=records.device)
            extra = (part.data_ptr(), flags.data_ptr())
        _build.check(getattr(lib, fn)(
            records.data_ptr(), buckets.rects.data_ptr(),
            buckets.bstarts.data_ptr(), buckets.bcounts.data_ptr(),
            *geometry, gtiles.data_ptr(), state.data_ptr(), int(depth_grad),
            *extra, drec.data_ptr(), torch.cuda.current_stream().cuda_stream),
            fn)
        return drec
    return call


def b_call(lib):
    """``blur_same`` on (planes, H, W) through the kernel B of ``lib``."""
    import torch

    from gslm_tpu_torch import _build

    def call(x, taps):
        y = torch.empty_like(x)
        taps_c = (ctypes.c_float * len(taps))(*taps)
        _build.check(lib.blur_same(x.data_ptr(), y.data_ptr(), x.shape[0],
                                   x.shape[1], x.shape[2], taps_c, len(taps),
                                   torch.cuda.current_stream().cuda_stream),
                     "blur_same")
        return y
    return call


def e_call(lib, fn: str = "composite_jvp"):
    """``composite_tiles_jvp`` through the kernel E entry ``fn`` of
    ``lib``."""
    import torch

    from gslm_tpu_torch import _build
    from gslm_tpu_torch.ops.rasterize_cuda import IMG_ROWS, OUT_ROWS, PIX

    def call(records, tangents, starts, counts, ntx, view_rows, rects=None):
        ntiles = counts.shape[0]
        out = torch.empty(ntiles, OUT_ROWS, PIX, device=records.device)
        out_dot = torch.empty(ntiles, IMG_ROWS, PIX, device=records.device)
        _build.check(getattr(lib, fn)(
            records.data_ptr(), tangents.data_ptr(),
            None if rects is None else rects.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), ntiles, ntx, view_rows, out.data_ptr(),
            out_dot.data_ptr(), torch.cuda.current_stream().cuda_stream), fn)
        return out, out_dot
    return call


def record_masks(records, starts, counts, ntx: int, view_rows: int,
                 tiles_per_call: int = 512):
    """(L,) uint8: each record's patch mask for the tile whose segment
    holds it (``patch_masks``; bucket 1, so every record has one tile)."""
    import torch

    from gslm_tpu_torch.ops.rasterize_cuda import patch_masks
    out = torch.zeros(records.shape[0], dtype=torch.uint8,
                      device=records.device)
    S = max(int(counts.max()), 1)
    slot = torch.arange(S, device=records.device)
    for t0 in range(0, counts.shape[0], tiles_per_call):
        tiles = torch.arange(t0, min(t0 + tiles_per_call, counts.shape[0]),
                             device=records.device)
        idx = starts[tiles, None].long() + slot[None]
        valid = slot[None] < counts[tiles, None]
        idx = torch.where(valid, idx, 0)
        m = patch_masks(records[idx], tiles, ntx, view_rows)
        out[idx[valid]] = m[valid].to(torch.uint8)
    return out


def timed_in_turns(fns: dict) -> dict:
    """{name: [ms per round]} of ``ROUNDS`` rounds in turns, the order
    reversed every round, one untimed round first."""
    times = {k: [] for k in fns}
    for r in range(ROUNDS + 1):
        for k in (list(fns) if r % 2 else list(fns)[::-1]):
            ms = cs.cuda_times(fns[k], 1, warmup=0)[0]
            if r:
                times[k].append(ms)
    return times


def report(kernel: str, label: str, n: int, held: str, times: dict,
           unit: str = "records") -> None:
    print(f"kernel {kernel} {label} ({n} {unit}): {held}; in turns, median "
          f"of {ROUNDS} (ms): "
          + ", ".join(f"{k} {statistics.median(v):.4f}"
                      for k, v in times.items())
          + "; runs " + ", ".join(f"{k} {[round(x, 4) for x in v]}"
                                  for k, v in times.items()), flush=True)


def close(got, want, tol: float) -> tuple[bool, bool, float, list]:
    """(bitwise equal, within ``tol`` of max |want| per column, the largest
    relative difference, per column [share of values that differ, max
    |got - want| / max |want|]) of (N, F, ...) outputs, columns F."""
    import torch
    cols = []
    for f in range(want.shape[1]):
        scale = float(want[:, f].abs().max()) + 1e-30
        d = (got[:, f] - want[:, f]).abs()
        cols.append([float((d > 0).float().mean()), float(d.max()) / scale])
    worst = max(c[1] for c in cols)
    bits = torch.equal(got.view(torch.int32), want.view(torch.int32))
    return bits, worst <= tol, worst, cols


def compare_a(calls: dict, label, records, starts, counts, ntx, view_rows,
              rects=None) -> None:
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
    times = timed_in_turns({"package": lambda: composite_tiles(*args),
                            **{k: (lambda c=c: c(*args))
                               for k, c in calls.items()}})
    report("A", label, records.shape[0], f"rows 0-6 and walked of "
           f"{sorted(calls)} bitwise equal to the package's", times)


def compare_bwd(kernel: str, package, calls: dict, label, args) -> None:
    """Kernel C or D (``kernel``): every build of ``calls`` within
    ``C_TOL`` of ``package`` per field on ``args``, then all timed."""
    want = package(*args)
    held = []
    for name, call in calls.items():
        bits, ok, worst, _ = close(call(*args), want, C_TOL)
        cs.check(ok, f"kernel {kernel} ({name}) is {worst:.3g} of max "
                     f"|package| from the package's on {label} (limit "
                     f"{C_TOL})")
        held.append(f"{name} {'bitwise equal' if bits else 'not bitwise'}, "
                    f"max|d|/max|package| {worst:.3g}")
    del want
    times = timed_in_turns({"package": lambda: package(*args),
                            **{k: (lambda c=c: c(*args))
                               for k, c in calls.items()}})
    report(kernel, f"{label} depth_grad={args[-1]}", args[0].shape[0],
           "; ".join(held), times)


def compare_b(calls: dict, label: str, planes) -> None:
    """Kernel B: every build ``torch.equal`` to the package's and to
    ``blur_plain`` on ``planes`` with the SSIM taps and reversed, then all
    timed in turns per taps."""
    import torch

    from gslm_tpu_torch.ops.blur_cuda import blur_plain, blur_same
    from gslm_tpu_torch.ops.ssim import gaussian_taps
    taps = tuple(float(t) for t in gaussian_taps())
    for name_t, tp in (("taps", taps), ("reversed taps", taps[::-1])):
        want = blur_same(planes, tp)
        cs.check(torch.equal(want, blur_plain(planes, tp)),
                 f"kernel B (package) differs from blur_plain on {label}")
        for name, call in calls.items():
            cs.check(torch.equal(call(planes, tp), want),
                     f"kernel B ({name}) differs from the package's on "
                     f"{label}, {name_t}")
        del want
        times = timed_in_turns({"package": lambda: blur_same(planes, tp),
                                **{k: (lambda c=c: c(planes, tp))
                                   for k, c in calls.items()}})
        report("B", f"{label} {name_t} {tuple(planes.shape)}",
               planes.numel(), f"{sorted(calls)} and blur_plain equal to the "
               f"package's (torch.equal)", times, "values")


def ssim_planes(dev):
    """Yield (label, the 15 SSIM planes) of the training view (the 131k
    scene with 50 exposure images against its target, the render with
    ``features_dc`` shifted by a seeded offset, as chip_smoke.py phase 5)
    and of view 0 of the 4-view serving batch against its ground truth."""
    import torch

    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.renderer import batch_render
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)

    def planes(a, b):
        return torch.cat([a, b, a * a, b * b, a * b], dim=0).contiguous()

    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        p = random_gaussians(np.random.default_rng(0), n=cs.N_GAUSS,
                             capacity=cs.N_GAUSS, sh_degree=3,
                             num_images=cs.EXPOSURES, spread=1.5,
                             scale_range=(-5.5, -3.5), device=dev)
        cam = ring_camera_batch(1, cs.H, cs.W, device=dev)
        cfg = RasterConfig(**cs.TRAIN_CAPS)
        img = batch_render(p, cam, bg, config=cfg).render[0]
        p.features_dc.add_(torch.tensor(np.random.default_rng(1).normal(
            0, 0.2, (cs.N_GAUSS, 1, 3)).astype(np.float32), device=dev))
        target = batch_render(p, cam, bg, config=cfg).render[0]
        yield "(training view)", planes(img, target)
        del p, img, target
        p = random_gaussians(np.random.default_rng(0), n=cs.N_GAUSS,
                             capacity=cs.N_GAUSS, sh_degree=3, spread=1.5,
                             scale_range=(-5.5, -3.5), device=dev)
        cams = ring_camera_batch(cs.VIEWS, cs.H, cs.W, device=dev)
        out = batch_render(p, cams, bg, config=RasterConfig(**cs.CAPS))
        yield "(served pair)", planes(out.render[0], cams.gt_image[0])


def compare_e(calls: dict, label, records, tangents, starts, counts, ntx,
              view_rows, rects=None) -> None:
    import torch

    from gslm_tpu_torch.ops.rasterize_cuda import composite_tiles_jvp
    args = (records, tangents, starts, counts, ntx, view_rows, rects)
    want, want_dot = composite_tiles_jvp(*args)
    held = []
    for name, call in calls.items():
        got, got_dot = call(*args)
        cs.check(torch.equal(got, want),
                 f"kernel E ({name}): primal differs from the package's on "
                 f"{label}")
        bits, ok, worst, cols = close(got_dot, want_dot, E_TOL)
        cs.check(ok, f"kernel E ({name}): tangent {worst:.3g} of max "
                     f"|package| from the package's on {label}")
        held.append(f"{name} primal bitwise equal, tangent "
                    f"{'bitwise equal' if bits else 'not bitwise'} (per row "
                    f"[share of values that differ, max|d|/max|package|] "
                    f"{[[float(f'{x:.3g}') for x in c] for c in cols]})")
        del got, got_dot
    del want, want_dot
    times = timed_in_turns({"package": lambda: composite_tiles_jvp(*args),
                            **{k: (lambda c=c: c(*args))
                               for k, c in calls.items()}})
    report("E", label, records.shape[0], "; ".join(held), times)


def scenes(dev, wanted):
    """Yield (label, records, starts, counts, ntx, view_rows, buckets) of the
    chip_smoke.py shapes whose label is in ``wanted``, one at a time, in
    this order: the 4-view serving stack, the training view, the LM window,
    m1 at bucket 4 (rects) and m1 at bucket 1."""
    import math

    from gslm_tpu_torch.config import LMParams
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig, _cdiv
    from gslm_tpu_torch.renderer import overflow_probe, stack_views
    from gslm_tpu_torch.train_lm import select_window
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)
    ntx, nty = _cdiv(cs.W, 16), _cdiv(cs.H, 16)

    def scene(seed: int, n: int, **kw):
        return random_gaussians(np.random.default_rng(seed), n=n, capacity=n,
                                sh_degree=3, spread=1.5,
                                scale_range=(-5.5, -3.5), device=dev, **kw)

    def records(params, cams, cfg, views=1):
        splats = stack_views(params, cams, config=cfg)[0]
        tr = rc.tile_records(splats, ntx, views * nty, cfg, nty)
        return tr.records, tr.starts, tr.counts, ntx, nty, tr.buckets

    cam = ring_camera_batch(1, cs.H, cs.W, device=dev)
    if "(4-view stack)" in wanted:
        cams = ring_camera_batch(cs.VIEWS, cs.H, cs.W, device=dev)
        yield ("(4-view stack)", *records(
            scene(0, cs.N_GAUSS), cams, RasterConfig(**cs.CAPS), cs.VIEWS))
    if {"(training view)", "(LM window)"} & set(wanted):
        p50 = scene(0, cs.N_GAUSS, num_images=cs.EXPOSURES)
    if "(training view)" in wanted:
        yield ("(training view)", *records(p50, cam,
                                           RasterConfig(**cs.TRAIN_CAPS)))
    if "(LM window)" in wanted:
        win = select_window(cs.EXPOSURES, LMParams().num_images,
                            np.random.default_rng(0))
        window = ring_camera_batch(cs.EXPOSURES, cs.H, cs.W, gt_seed=None,
                                   device=dev).take(win)
        yield ("(LM window)", *records(p50, window,
                                       RasterConfig(**cs.LM_CAPS), len(win)))
    p50 = None
    if {"(m1 bucket 4)", "(m1 bucket 1)"} & set(wanted):
        m1 = scene(2, cs.M1_N, num_images=1)
    if "(m1 bucket 4)" in wanted:
        yield ("(m1 bucket 4)", *records(m1, cam,
                                         RasterConfig(**cs.M1_CAPS)))
    if "(m1 bucket 1)" in wanted:
        pr = overflow_probe(m1, cam, config=RasterConfig(cull=True))
        yield ("(m1 bucket 1)", *records(m1, cam, RasterConfig(
            dup_capacity=256 * math.ceil(1.05 * int(pr["n_aabb"]) / 256),
            live_capacity=256 * math.ceil(1.05 * int(pr["n_live"]) / 256),
            cull=True)))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=sorted(LIBS))
    ap.add_argument("builds", nargs="+", metavar="NAME=FILE.cu",
                    help="sources of the kernel to hold against the "
                         "package's")
    ap.add_argument("--sass-dir", metavar="DIR",
                    help="write every build's SASS there in basic blocks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 1
    from gslm_tpu_torch import _build
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    kernel, lib = args.kernel, LIBS[args.kernel]
    print(f"card: {cs.card_line()}", flush=True)
    builds = [b.split("=", 1) for b in args.builds]
    if kernel == "C":
        out_dir = _build.BUILD_DIR / "compare"
        out_dir.mkdir(parents=True, exist_ok=True)
        builds.append(("premasked", premasked_source(out_dir)))
    started = [start_build(kernel, *b) for b in builds]
    _build.build_all()
    libs = {"package": _build.load(lib),
            **{name: finish_build(kernel, name, proc, so)
               for name, proc, so in started}}
    attrs = {"A": cs.fwd_attrs, "C": cs.bwd_attrs, "D": cs.bucket_bwd_attrs,
             "E": cs.jvp_attrs}.get(kernel)
    for name, cdll in libs.items():
        if attrs and hasattr(cdll, f"{lib}_attrs"):
            print(f"kernel {kernel} ({name}) registers, static shared bytes, "
                  f"resident 256-thread blocks per SM: {attrs(cdll)}",
                  flush=True)
    cs.sass_totals({f"{lib}_{k}": cdll._name for k, cdll in libs.items()},
                   args.sass_dir)
    dev = torch.device("cuda")
    others = {k: v for k, v in libs.items() if k != "package"}
    if kernel == "B":
        for label, planes in ssim_planes(dev):
            compare_b({k: b_call(v) for k, v in others.items()}, label,
                      planes)
            del planes
        return 0
    gen = torch.Generator(dev).manual_seed(1)
    shapes = {"A": ("(4-view stack)", "(training view)", "(LM window)",
                    "(m1 bucket 4)"),
              "C": ("(training view)", "(LM window)", "(m1 bucket 1)"),
              "D": ("(m1 bucket 4)",),
              "E": ("(LM window)", "(m1 bucket 4)")}[kernel]
    with torch.no_grad():
        for label, rec, st, cn, ntx, vrows, buckets in scenes(dev, shapes):
            rects = None if buckets is None else buckets.rects
            if kernel == "A":
                compare_a({k: a_call(v) for k, v in others.items()}, label,
                          rec, st, cn, ntx, vrows, rects)
            elif kernel in "CD":
                state = rc.composite_tiles(
                    rec, st, cn, ntx, vrows, rects)[0][:, 5:].contiguous()
                gt = torch.randn(cn.shape[0], rc.IMG_ROWS, rc.PIX,
                                 device=dev, generator=gen)
                depth_grad = label != "(LM window)"
                if kernel == "D":
                    args = (rec, buckets, ntx, vrows, gt, state, depth_grad)
                    calls = {k: d_call(v) for k, v in others.items()}
                    calls["guard"] = d_call(libs["package"],
                                            "composite_bucket_bwd_unmasked")
                    compare_bwd("D", rc.composite_tiles_bucket_bwd, calls,
                                label, args)
                    print(f"kernel D {label}: the package's kernels per "
                          f"call (profiler, ms, medians of 10 calls): "
                          f"{cs.d_kernels_ms(args, 10)}", flush=True)
                    del args
                else:
                    masks = record_masks(rec, st, cn, ntx, vrows)
                    _build.check(libs["premasked"].composite_bwd_set_masks(
                        masks.data_ptr()), "composite_bwd_set_masks")
                    calls = {k: c_call(v) for k, v in others.items()}
                    calls["guard"] = c_call(libs["package"],
                                            "composite_bwd_unmasked")
                    compare_bwd("C", rc.composite_tiles_bwd, calls, label,
                                (rec, st, cn, ntx, vrows, gt, state,
                                 depth_grad))
                    del masks
                del state, gt
            else:
                tng = (torch.randn(rec.shape, device=dev, generator=gen)
                       * rec.std(dim=0, keepdim=True))
                calls = {k: e_call(v) for k, v in others.items()}
                calls["guard"] = e_call(libs["package"],
                                        "composite_jvp_unmasked")
                compare_e(calls, label, rec, tng, st, cn, ntx, vrows, rects)
                del tng
            del rec, st, cn, rects, buckets
    return 0


if __name__ == "__main__":
    sys.exit(main())
