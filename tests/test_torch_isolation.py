"""gslm_tpu_torch stands alone: it imports neither JAX nor gslm_tpu, nor,
when its modules are imported, Pillow, OpenCV, torchvision, tqdm or
TensorBoard (absent where the card is); every module counts, the
multi-rank ``parallel`` package included (its model axis: ``comm``,
``model_raster``); and its entry points never
drift onto the CPU unasked (under a process group:
tests/test_torch_parallel.py::test_mesh_shapes)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import torch
# torch itself may import tqdm: for tqdm only the port's own imports count
by_torch = set(sys.modules)
import gslm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gslm_tpu_torch.__path__,
                                               "gslm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import compare_kernels
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "gslm_tpu", "PIL", "cv2",
                      "torchvision")
             or m.startswith(("jax.", "jaxlib.", "gslm_tpu.", "PIL.",
                              "cv2.", "torchvision."))
             or (m not in by_torch
                 and m.split(".")[0] in ("tqdm", "tensorboard")
                 or m.startswith("torch.utils.tensorboard")))
print(len(names), bad)
assert not bad, bad
assert {"gslm_tpu_torch.parallel", "gslm_tpu_torch.parallel.mesh",
        "gslm_tpu_torch.parallel.steps", "gslm_tpu_torch.parallel.comm",
        "gslm_tpu_torch.parallel.model_raster"} <= set(names), names
"""


def test_port_imports_no_jax_and_no_gslm_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 58


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    from gslm_tpu_torch.models.cameras import camera_from_arrays
    from gslm_tpu_torch.models.gaussians import create_from_pcd
    from gslm_tpu_torch.utils.synthetic import (make_camera, random_gaussians,
                                                ring_camera_batch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_gaussians(np.random.default_rng(0), n=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ring_camera_batch(1, 16, 16)
    meta = make_camera(16, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        camera_from_arrays(meta.R, meta.T, meta.fovx, meta.fovy, 16, 16)
    assert random_gaussians(np.random.default_rng(0), n=8,
                            device="cpu").xyz.device.type == "cpu"
    pts = np.random.default_rng(1).normal(size=(8, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_from_pcd(pts, np.full((8, 3), 0.5), num_images=1)
    params, _ = create_from_pcd(pts, np.full((8, 3), 0.5), num_images=1,
                                device="cpu")
    assert params.xyz.device.type == "cpu"
