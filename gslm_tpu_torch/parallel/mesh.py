"""Ranks over a (data, model) mesh (gslm_tpu/parallel/mesh.py) on
``torch.distributed``.

JAX runs one process over a mesh of devices and lets GSPMD or shard_map
place each array's shards. The port runs one process per rank (torchrun's
layout): every rank holds its own copy of what it needs, and the
collectives are explicit ``dist.all_reduce`` and ``dist.broadcast`` calls
on the data axis's process group. Gloo takes them on CUDA tensors too
(all_reduce with SUM and MAX, broadcast: chip_smoke.py phase 13 checks
each), so ranks that share one card need no host staging of their own.

The data axis (views split over ranks) is the one that exists: the
parameters, the Adam moments and the densification statistics are
replicated, each rank renders a contiguous block of the views
(``shard_cameras``, as ``P("data")`` splits the leading axis), and the
gradients, Jᵀ·u partials, residual dots and losses are summed over the
ranks. The model axis (Gaussians sharded over ranks) is not ported yet:
``n_model > 1`` raises. JAX's ``NamedSharding`` helpers
(``params_sharding`` ... ``replicated``) have no PyTorch counterpart and
are not ported.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

MODEL_AXIS_MESSAGE = ("the model axis (Gaussians sharded over ranks) is not "
                      "ported yet (ROADMAP.md queue 1, item 2)")


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), where JAX reads its coordinator variables.

    Returns True if a group is (already) up: a caller that started its own
    group passes through. Without those variables this is a no-op that
    returns False. ``backend`` is fixed before start-up: "nccl" for CUDA
    ranks, "gloo" for CPU ranks; None takes "nccl" where CUDA is available
    and "gloo" elsewhere. A CUDA rank's current device is set to
    ``cuda:{LOCAL_RANK % device_count}`` first."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: 'nccl' (CUDA ranks) or "
                         "'gloo' (CPU ranks)")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", env["RANK"]))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks as a (data, model) grid: ``shape`` is ``{"data": n,
    "model": m}`` as JAX's ``Mesh.shape``; ``rank`` is this process's
    index on the data axis and ``group`` the data axis's process group
    (None on the single process's 1x1 mesh)."""

    n_data: int
    n_model: int
    rank: int
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files and prints."""
        return self.rank == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` items split over the data
        axis (``n`` must divide evenly)."""
        if n % self.n_data:
            raise ValueError(f"{n} views do not split over a data axis of "
                             f"{self.n_data}")
        per = n // self.n_data
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_data: int | None = None, n_model: int | None = None) -> Mesh:
    """A (data, model) mesh over the world group: with no sizes given,
    every rank goes to the data axis. ``n_data * n_model`` must equal the
    world size (1 without a process group)."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if n_data is None and n_model is None:
        n_data, n_model = world, 1
    elif n_data is None:
        n_data = world // n_model
    elif n_model is None:
        n_model = world // n_data
    if n_model != 1:
        raise NotImplementedError(f"n_model={n_model}: {MODEL_AXIS_MESSAGE}")
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh must fill the world of "
                         f"{world} rank(s)")
    return Mesh(n_data=n_data, n_model=n_model,
                rank=dist.get_rank() if up else 0,
                group=dist.group.WORLD if up else None)


def axis_group(axis_name: str):
    """The process group of a mesh axis (``LMOperators`` and
    ``lm_outer_step``'s ``axis_name``): the data axis spans the world, or
    is None (no collective) without a process group."""
    if axis_name != "data":
        raise NotImplementedError(f"axis_name={axis_name!r}: only the data "
                                  f"axis exists; {MODEL_AXIS_MESSAGE}")
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() \
        else None


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    """One flat buffer of same-dtype tensors; bool travels as uint8."""
    buf = torch.cat([t.detach().reshape(-1) for t in tensors])
    return buf.to(torch.uint8) if buf.dtype == torch.bool else buf


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(tensors: list[torch.Tensor], op: str, group) -> list:
    """The ``op`` ("sum" or "max") of each tensor over ``group``'s ranks,
    as new tensors: one flat buffer and one collective per dtype. Without
    a group the tensors come back as they are (a group of one rank still
    runs its collectives)."""
    if group is None:
        return list(tensors)
    out = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        buf = _flat([tensors[i] for i in idx])
        dist.all_reduce(buf, op=_OPS[op], group=group)
        for i, part in zip(idx, torch.split(
                buf.to(dtype), [tensors[i].numel() for i in idx])):
            out[i] = part.reshape(tensors[i].shape)
    return out


def all_reduce_dict(d: dict, op: str, group) -> dict:
    return dict(zip(d, all_reduce(list(d.values()), op, group)))


def broadcast_(tensors: list[torch.Tensor], group, src: int = 0) -> None:
    """Copy rank ``src``'s values into every rank's ``tensors``, in place:
    one flat buffer and one collective per dtype."""
    if group is None:
        return
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        buf = _flat(same)
        dist.broadcast(buf, src=src, group=group)
        with torch.no_grad():
            for t, part in zip(same, torch.split(
                    buf.to(dtype), [t.numel() for t in same])):
                t.copy_(part.reshape(t.shape))


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of ``mesh`` (no-op on one rank)."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def shard_cameras(mesh: Mesh, cams):
    """This rank's contiguous block of the views of ``cams`` (a
    ``CameraBatch`` whose view count divides by the data axis)."""
    return cams.take(mesh.block(cams.batch_size))


def shard_state(mesh: Mesh, params, aux=None, opt_state=None):
    """Make every rank's training state rank 0's, bit for bit, in place
    (``broadcast_`` of the parameters, ``alive``, the statistics and the
    Adam moments; the Adam step count must already agree). Returns the
    same objects, as JAX's ``shard_state`` returns the placed ones."""
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    tensors = [getattr(params, g) for g in PARAM_GROUPS] + [params.alive]
    if aux is not None:
        tensors += [aux.max_radii2d, aux.xyz_gradient_accum, aux.denom]
    if opt_state is not None:
        tensors += [opt_state.mu[g] for g in PARAM_GROUPS]
        tensors += [opt_state.nu[g] for g in PARAM_GROUPS]
    broadcast_(tensors, mesh.group)
    out = [params] + [x for x in (aux, opt_state) if x is not None]
    return out[0] if len(out) == 1 else tuple(out)
