"""Build and load the CUDA kernels in ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by nvcc, on its own, into a shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. The library name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale one is never
loaded. ``build_all`` starts one nvcc per source, all at once.

No ``--use_fast_math``: the compositors' parity with their plain versions
needs IEEE ``expf``/``log1pf``. Every ``csrc/*.cuh`` header enters every
library's hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# name -> loaded library; filled at first use, one build per process
_LIBS: dict[str, ctypes.CDLL] = {}

# C signatures: every pointer and the stream are void*, counts are int
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "composite_fwd": {"composite_fwd": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP,
                                        _VP, _VP],
                      "composite_fwd_attrs": [_VP]},
    "composite_bwd": {"composite_bwd": [_VP, _VP, _VP, _I, _I, _I, _VP, _VP,
                                        _I, _VP, _VP],
                      "composite_bwd_unmasked": [_VP, _VP, _VP, _I, _I, _I,
                                                 _VP, _VP, _I, _VP, _VP],
                      "composite_bwd_attrs": [_VP]},
    "composite_bucket_bwd": {
        "composite_bucket_bwd": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                 _VP, _VP, _I, _VP, _VP, _VP, _VP],
        "composite_bucket_bwd_unmasked": [_VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                          _I, _I, _VP, _VP, _I, _VP, _VP, _VP,
                                          _VP],
        "composite_bucket_bwd_attrs": [_VP]},
    "composite_jvp": {"composite_jvp": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                        _VP, _VP, _VP],
                      "composite_jvp_unmasked": [_VP, _VP, _VP, _VP, _VP, _I,
                                                 _I, _I, _VP, _VP, _VP],
                      "composite_jvp_attrs": [_VP]},
    "blur": {"blur_same": [_VP, _VP, _I, _I, _I, _VP, _I, _VP]},
    "knn": {"knn_mean_sq_dist": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                                 _VP],
            "knn_mean_sq_dist_pairs": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP,
                                       _VP, _VP, _VP],
            "knn_attrs": [_VP]},
    "cell_masks": {"cell_masks": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                  _I, _VP, _VP, _VP, _VP, _VP, _VP],
                   "cell_masks_attrs": [_VP]},
    "preprocess": {"preprocess": [_VP] * 6 + [_I] + [_VP] * 8
                   + [_I] * 5 + [_F] + [_VP] * 12,
                   "preprocess_attrs": [_VP]},
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, verbose: bool):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temporary output, final path)."""
    out = _lib_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path, verbose: bool):
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        if verbose and log:
            print(f"[nvcc {name}] {log.strip()}", flush=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def build_all(verbose: bool = False) -> None:
    """Build every kernel of ``csrc/`` in parallel, one nvcc per source."""
    started = {n: _start(n, verbose) for n in SIGNATURES if n not in _LIBS}
    for n, (proc, tmp, out) in started.items():
        _finish(n, proc, tmp, out, verbose)


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _finish(name, *_start(name, False), False)
    return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
