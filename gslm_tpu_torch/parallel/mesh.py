"""Ranks over a (data, model) mesh (gslm_tpu/parallel/mesh.py) on
``torch.distributed``.

JAX runs one process over a mesh of devices and lets GSPMD or shard_map
place each array's shards. The port runs one process per rank (torchrun's
layout) and lays the ranks out as JAX lays out devices,
``grid.reshape(n_data, n_model)``: rank r is data index ``r // n_model``
and model index ``r % n_model``. Each axis has its process groups: the
data axis's group holds the ranks that share a model index (the world at
a model axis of 1), the model axis's group the ranks that share a data
index. Every rank creates every group, in the same order. The collectives
are explicit calls on those groups (one flat buffer per dtype); the ones
that carry gradients live in ``parallel/comm.py``.

- ``data`` axis: views split over ranks. Each rank renders a contiguous
  block of the views (``shard_cameras``, as ``P("data")`` splits the
  leading axis); gradients, Jᵀ·u partials, residual dots and losses are
  summed over the axis.
- ``model`` axis: the Gaussian capacity axis. Each rank holds its
  contiguous block of C/M rows of the parameters, the Adam moments and the
  densification statistics (``shard_state``, as ``P("model")`` splits
  them); ``exposure`` and the Adam step count are replicated.
  ``parallel/model_raster.py`` renders tile-row bands from such shards.

Gloo takes every collective the port calls on CUDA tensors too (all_reduce
SUM and MAX, broadcast, all_gather, all_to_all_single: chip_smoke.py
phases 13 and 14 check each), so ranks that share one card need no host
staging. JAX's ``NamedSharding`` helpers
(``params_sharding`` ... ``replicated``) have no PyTorch counterpart and
are not ported.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

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
    "model": m}`` as JAX's ``Mesh.shape``. ``rank`` is this process's index
    on the data axis and ``group`` the data axis's process group;
    ``model_rank`` and ``model_group`` the same on the model axis;
    ``world_group`` spans every rank. Under a process group the world's
    group is always there (a world of one rank still runs its collectives),
    and at a model axis of 1 the data axis's group is the world's; an axis
    group of one rank inside a larger world is None (no collective). The
    single process's 1x1 mesh has no group at all."""

    n_data: int
    n_model: int
    rank: int
    group: object = None
    model_rank: int = 0
    model_group: object = None
    world_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def is_main(self) -> bool:
        """World rank 0: the one that writes files and prints."""
        return self.rank == 0 and self.model_rank == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` items split over the data
        axis (``n`` must divide evenly)."""
        if n % self.n_data:
            raise ValueError(f"{n} views do not split over a data axis of "
                             f"{self.n_data}")
        per = n // self.n_data
        return slice(self.rank * per, (self.rank + 1) * per)

    def rows(self, capacity: int) -> slice:
        """This rank's contiguous block of the ``capacity`` Gaussian rows
        split over the model axis; a capacity that does not divide raises
        ``ValueError`` (JAX asserts)."""
        if capacity % self.n_model:
            raise ValueError(f"capacity {capacity} does not split over a "
                             f"model axis of {self.n_model}")
        per = capacity // self.n_model
        return slice(self.model_rank * per, (self.model_rank + 1) * per)


def _axis_groups(ranks_of: list[list[int]], world: int) -> list:
    """One process group per rank list, created by every rank in order: a
    list of one rank has none (None), the whole world is the world group."""
    out = []
    for ranks in ranks_of:
        if len(ranks) == 1:
            out.append(None)
        elif len(ranks) == world:
            out.append(dist.group.WORLD)
        else:
            out.append(dist.new_group(ranks))
    return out


def make_mesh(n_data: int | None = None, n_model: int | None = None) -> Mesh:
    """A (data, model) mesh over the world group: with no sizes given,
    every rank goes to the data axis. ``n_data * n_model`` must equal the
    world size (1 without a process group). With a model axis above 1
    every rank creates the axes' subgroups (``dist.new_group``), so every
    rank must call this, in the same order as its other collectives."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if n_data is None and n_model is None:
        n_data, n_model = world, 1
    elif n_data is None:
        n_data = world // n_model
    elif n_model is None:
        n_model = world // n_data
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh must fill the world of "
                         f"{world} rank(s)")
    whole = dist.group.WORLD if up else None
    rank = dist.get_rank() if up else 0
    d, m = divmod(rank, n_model)
    if n_model == 1:
        return Mesh(n_data=n_data, n_model=1, rank=d, group=whole,
                    world_group=whole)
    model_groups = _axis_groups(
        [[dd * n_model + mm for mm in range(n_model)]
         for dd in range(n_data)], world)
    data_groups = _axis_groups(
        [[dd * n_model + mm for dd in range(n_data)]
         for mm in range(n_model)], world)
    return Mesh(n_data=n_data, n_model=n_model, rank=d, group=data_groups[m],
                model_rank=m, model_group=model_groups[d], world_group=whole)


def axis_group(axis_name, mesh: Mesh | None = None):
    """The process group of a mesh axis (``LMOperators`` and
    ``lm_outer_step``'s ``axis_name`` / ``param_axis``): "data", "model",
    or a tuple of both (the world). Without ``mesh`` only the data axis
    exists, and it spans the world, or is None (no collective) without a
    process group."""
    if mesh is not None:
        names = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
            else (axis_name,)
        if set(names) == {"data", "model"}:
            return mesh.world_group
        if names == ("data",):
            return mesh.group
        if names == ("model",):
            return mesh.model_group
        raise ValueError(f"axis_name={axis_name!r}: the mesh's axes are "
                         "'data' and 'model'")
    if axis_name != "data":
        raise ValueError(f"axis_name={axis_name!r} needs the mesh that has "
                         "it (mesh=)")
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
    if mesh is not None and mesh.world_group is not None:
        dist.barrier(group=mesh.world_group)


def shard_cameras(mesh: Mesh, cams):
    """This rank's contiguous block of the views of ``cams`` (a
    ``CameraBatch`` whose view count divides by the data axis)."""
    return cams.take(mesh.block(cams.batch_size))


_AUX = ("max_radii2d", "xyz_gradient_accum", "denom")


def _state_tensors(params, aux, opt_state) -> list:
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    tensors = [getattr(params, g) for g in PARAM_GROUPS] + [params.alive]
    if aux is not None:
        tensors += [getattr(aux, f) for f in _AUX]
    if opt_state is not None:
        tensors += [opt_state.mu[g] for g in PARAM_GROUPS]
        tensors += [opt_state.nu[g] for g in PARAM_GROUPS]
    return tensors


def _row_groups() -> tuple:
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    return tuple(g for g in PARAM_GROUPS if g != "exposure")


def _row_tensors(params, aux, opt_state) -> list:
    """The per-Gaussian tensors of a training state (the ones the model
    axis splits), in ``_with_rows``' order."""
    rows = _row_groups()
    out = [getattr(params, g).detach() for g in rows] + [params.alive]
    if aux is not None:
        out += [getattr(aux, f) for f in _AUX]
    if opt_state is not None:
        out += [opt_state.mu[g] for g in rows] + [opt_state.nu[g]
                                                   for g in rows]
    return out


def _with_rows(params, aux, opt_state, new: list) -> list:
    """The training state with its per-Gaussian tensors replaced by
    ``new`` (``_row_tensors``' order), as new objects; exposure, its
    moments and the step count copied. Returns ``[params, aux, opt_state]``
    without the ones not given."""
    from gslm_tpu_torch.models.gaussians import GaussianParams
    from gslm_tpu_torch.optim import AdamState
    rows = _row_groups()
    it = iter(new)
    groups = {g: next(it) for g in rows}
    alive = next(it)
    out = [GaussianParams(**groups, exposure=params.exposure.detach().clone(),
                          sh_degree=params.sh_degree, alive=alive)]
    if aux is not None:
        out.append(aux.replace(**{f: next(it) for f in _AUX}))
    if opt_state is not None:
        mu = {g: next(it) for g in rows}
        nu = {g: next(it) for g in rows}
        out.append(AdamState(
            mu=mu | {"exposure": opt_state.mu["exposure"].clone()},
            nu=nu | {"exposure": opt_state.nu["exposure"].clone()},
            step=opt_state.step))
    return out


def shard_state(mesh: Mesh, params, aux=None, opt_state=None):
    """Place a training state on the mesh. Every rank first takes rank 0's
    state, bit for bit (``broadcast_`` of the parameters, ``alive``, the
    statistics and the Adam moments; the Adam step count must already
    agree). At a model axis of 1 that is all, in place, and the same
    objects come back; above 1 each rank keeps its block of rows
    (``Mesh.rows``, as ``P("model")`` splits the capacity axis), returned as
    new objects, exposure and its moments replicated. A capacity that does
    not divide by the model axis raises ``ValueError``."""
    rows = mesh.rows(params.capacity)     # raises before any collective
    broadcast_(_state_tensors(params, aux, opt_state), mesh.world_group)
    if mesh.n_model > 1:
        out = _with_rows(params, aux, opt_state, [
            t[rows].clone() for t in _row_tensors(params, aux, opt_state)])
    else:
        out = [params] + [x for x in (aux, opt_state) if x is not None]
    return out[0] if len(out) == 1 else tuple(out)


def _rows_of_ranks(tensors: list[torch.Tensor], group, dst) -> list | None:
    """``all_gather_rows`` (``dst`` None) or its gather onto the group's
    rank ``dst`` alone (None on the others)."""
    n = dist.get_world_size(group)
    mine = dst is None or dist.get_rank(group) == dst
    out = [None] * len(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        buf = _flat([tensors[i] for i in idx])
        parts = [torch.empty_like(buf) for _ in range(n)] if mine else None
        if dst is None:
            dist.all_gather(parts, buf, group=group)
        else:
            dist.gather(buf, parts, dst=dist.get_global_rank(group, dst),
                        group=group)
        if not mine:
            continue
        got = torch.stack(parts).to(dtype)
        sizes = [tensors[i].numel() for i in idx]
        for i, part in zip(idx, torch.split(got, sizes, dim=1)):
            t = tensors[i]
            out[i] = part.reshape((n * t.shape[0],) + t.shape[1:]) \
                if t.ndim else part.reshape(n)
    return out if mine else None


def all_gather_rows(tensors: list[torch.Tensor], group) -> list:
    """Each tensor's rows from every rank of ``group``, concatenated in
    rank order (no autograd): one flat buffer and one
    ``all_gather`` per dtype. Without a group the tensors come back as
    they are."""
    if group is None:
        return list(tensors)
    return _rows_of_ranks(tensors, group, None)


def gather_state(mesh: Mesh, params, aux=None, opt_state=None):
    """The whole training state from the model axis's shards (the implicit
    gather of JAX's sharded arrays), on the model group's first rank alone:
    the rows of every rank of the group in rank order, as new objects,
    exposure, its moments and the step count copied; None on the group's
    other ranks. One ``gather`` per dtype. At a model axis of 1 the same
    objects come back. Every rank of the model group must call it."""
    if mesh.n_model == 1:
        out = [params] + [x for x in (aux, opt_state) if x is not None]
    else:
        rows = _rows_of_ranks(_row_tensors(params, aux, opt_state),
                              mesh.model_group, 0)
        if rows is None:
            return None
        out = _with_rows(params, aux, opt_state, rows)
    return out[0] if len(out) == 1 else tuple(out)
