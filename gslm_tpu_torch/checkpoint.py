"""Training checkpoints (gslm_tpu/checkpoint.py): the whole training state
(parameters, alive mask and densification statistics, Adam moments,
iteration) as one ``.npz`` of named arrays, no pickle.

The keys are the JAX package's, so a checkpoint written by either package
loads in the other: ``params/<group>``; ``aux/alive`` (written from, and
read into, ``params.alive``), ``aux/max_radii2d``,
``aux/xyz_gradient_accum``, ``aux/denom``; ``opt/mu/<group>``,
``opt/nu/<group>``, ``opt/step`` (int32 0-d); ``iteration``,
``spatial_lr_scale`` and ``sh_degree``. PLY export, the interchange
format, is ``Scene.save``'s."""

from __future__ import annotations

import os

import numpy as np
import torch

from gslm_tpu_torch.device import resolve_device
from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                             GaussianParams)
from gslm_tpu_torch.optim import AdamState

_AUX = ("max_radii2d", "xyz_gradient_accum", "denom")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(path: str, params: GaussianParams, aux: GaussianAux,
                    opt_state: AdamState, iteration: int,
                    spatial_lr_scale: float = 1.0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = {f"params/{g}": _host(getattr(params, g)) for g in PARAM_GROUPS}
    data["aux/alive"] = _host(params.alive)
    data.update({f"aux/{k}": _host(getattr(aux, k)) for k in _AUX})
    for name, moments in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        data.update({f"opt/{name}/{g}": _host(moments[g])
                     for g in PARAM_GROUPS})
    data["opt/step"] = np.asarray(opt_state.step, np.int32)
    data["iteration"] = np.asarray(iteration)
    data["spatial_lr_scale"] = np.asarray(spatial_lr_scale)
    data["sh_degree"] = np.asarray(params.sh_degree)
    np.savez(path, **data)


def load_checkpoint(path: str, device=None):
    """→ (params, aux, opt_state, iteration, spatial_lr_scale) on
    ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        def t(key):
            return torch.from_numpy(z[key]).to(dev)

        params = GaussianParams(
            **{g: t(f"params/{g}") for g in PARAM_GROUPS},
            sh_degree=int(z["sh_degree"]), alive=t("aux/alive"))
        aux = GaussianAux(**{k: t(f"aux/{k}") for k in _AUX})
        opt_state = AdamState(
            mu={g: t(f"opt/mu/{g}") for g in PARAM_GROUPS},
            nu={g: t(f"opt/nu/{g}") for g in PARAM_GROUPS},
            step=int(z["opt/step"]))
        return (params, aux, opt_state, int(z["iteration"]),
                float(z["spatial_lr_scale"]))
