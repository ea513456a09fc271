"""Training checkpoints (gslm_tpu/checkpoint.py): the whole training state
(parameters, alive mask and densification statistics, Adam moments,
iteration) as one ``.npz`` of named arrays, no pickle.

The keys are the JAX package's, so a checkpoint written by either package
loads in the other: ``params/<group>``; ``aux/alive`` (written from, and
read into, ``params.alive``), ``aux/max_radii2d``,
``aux/xyz_gradient_accum``, ``aux/denom``; ``opt/mu/<group>``,
``opt/nu/<group>``, ``opt/step`` (int32 0-d); ``iteration``,
``spatial_lr_scale`` and ``sh_degree``. PLY export, the interchange
format, is ``Scene.save``'s.

A model-sharded state (``parallel.shard_state``) is written per shard
(``save_checkpoint_sharded``), where JAX writes an orbax directory: a
directory of one ``shard<m>.npz`` per model index, under the same keys,
written by data rank 0 of that index, and ``meta.json`` (``iteration``,
``spatial_lr_scale``, ``sh_degree``, ``n_model``) by rank 0. numpy reads
it, and the whole state is the shards' rows concatenated in order."""

from __future__ import annotations

import json
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


def _arrays(params: GaussianParams, aux: GaussianAux,
            opt_state: AdamState) -> dict:
    data = {f"params/{g}": _host(getattr(params, g)) for g in PARAM_GROUPS}
    data["aux/alive"] = _host(params.alive)
    data.update({f"aux/{k}": _host(getattr(aux, k)) for k in _AUX})
    for name, moments in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        data.update({f"opt/{name}/{g}": _host(moments[g])
                     for g in PARAM_GROUPS})
    data["opt/step"] = np.asarray(opt_state.step, np.int32)
    return data


def save_checkpoint(path: str, params: GaussianParams, aux: GaussianAux,
                    opt_state: AdamState, iteration: int,
                    spatial_lr_scale: float = 1.0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = _arrays(params, aux, opt_state)
    data["iteration"] = np.asarray(iteration)
    data["spatial_lr_scale"] = np.asarray(spatial_lr_scale)
    data["sh_degree"] = np.asarray(params.sh_degree)
    np.savez(path, **data)


def _state(arrays, sh_degree: int, dev):
    def t(key):
        return torch.from_numpy(np.asarray(arrays[key])).to(dev)

    params = GaussianParams(
        **{g: t(f"params/{g}") for g in PARAM_GROUPS},
        sh_degree=sh_degree, alive=t("aux/alive"))
    aux = GaussianAux(**{k: t(f"aux/{k}") for k in _AUX})
    opt_state = AdamState(
        mu={g: t(f"opt/mu/{g}") for g in PARAM_GROUPS},
        nu={g: t(f"opt/nu/{g}") for g in PARAM_GROUPS},
        step=int(arrays["opt/step"]))
    return params, aux, opt_state


def load_checkpoint(path: str, device=None):
    """→ (params, aux, opt_state, iteration, spatial_lr_scale) on
    ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return (*_state(z, int(z["sh_degree"]), dev), int(z["iteration"]),
                float(z["spatial_lr_scale"]))


def _replicated(key: str) -> bool:
    """Keys every shard holds whole: exposure, its moments, the step."""
    return key.endswith("/exposure") or key == "opt/step"


def save_checkpoint_sharded(path: str, params: GaussianParams,
                            aux: GaussianAux, opt_state: AdamState,
                            iteration: int, spatial_lr_scale: float = 1.0,
                            mesh=None) -> None:
    """Write this rank's shard of a model-sharded state into the directory
    ``path`` (``mesh``: the ``parallel.Mesh``; None is one shard, the whole
    state). Data rank 0 of each model index writes ``shard<m>.npz``, rank
    0 ``meta.json``; every rank then waits at the mesh's barrier."""
    from gslm_tpu_torch.parallel.mesh import barrier
    m = 0 if mesh is None else mesh.model_rank
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, f"shard{m}.npz"),
                 **_arrays(params, aux, opt_state))
    if mesh is None or mesh.is_main:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"iteration": int(iteration),
                       "spatial_lr_scale": float(spatial_lr_scale),
                       "sh_degree": int(params.sh_degree),
                       "n_model": 1 if mesh is None else mesh.n_model}, f)
    barrier(mesh)


def load_checkpoint_sharded(path: str, mesh=None, device=None):
    """Read a ``save_checkpoint_sharded`` directory: without ``mesh`` the
    whole state (the shards' rows concatenated), with one this rank's
    rows of it (``Mesh.rows``; its own file where the shard counts
    agree). → (params, aux, opt_state, iteration, spatial_lr_scale) on
    ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    n = meta["n_model"]
    if mesh is not None and mesh.n_model == n:
        files = [f"shard{mesh.model_rank}.npz"]
    else:
        files = [f"shard{m}.npz" for m in range(n)]
    shards = []
    for name in files:
        with np.load(os.path.join(path, name)) as z:
            shards.append({k: z[k] for k in z.files})
    arrays = {k: shards[0][k] if _replicated(k)
              else np.concatenate([sh[k] for sh in shards])
              for k in shards[0]}
    if mesh is not None and mesh.n_model != n:
        rows = mesh.rows(arrays["aux/alive"].shape[0])
        arrays = {k: v if _replicated(k) else v[rows]
                  for k, v in arrays.items()}
    return (*_state(arrays, meta["sh_degree"], dev), meta["iteration"],
            meta["spatial_lr_scale"])
