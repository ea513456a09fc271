"""Collectives that carry derivatives across the model axis
(gslm_tpu/parallel/model_raster.py's ``all_gather`` and ``all_to_all``).

Each is a ``torch.autograd.Function`` with ``forward``, ``backward`` and
``jvp``, so the exchange sits inside both the Adam step's reverse mode and
the LM step's forward mode (J·v is ``torch.autograd.forward_ad``: the
gathered records arrive as dual tensors, which routes the compositor to
kernel E):

- ``all_gather(x, group, dim)``: every rank's ``x`` concatenated along
  ``dim`` in rank order. Its backward is the reduce-scatter sum (JAX's
  all_gather transpose: each rank gets the sum over the ranks of its own
  block's cotangent), one reduce-scatter; its jvp the all_gather of the
  tangent.
- ``all_to_all(x, group)``: ``x`` (M·R, ...) holds one R-row block per
  destination rank; rank d receives block d of every rank, source-major.
  It is its own transpose, so backward and jvp are all_to_alls too.

The gradient contract is JAX's (model_raster.py:349-357): no sum over the
ranks inside the differentiated region; each rank differentiates its local
partial of the objective, and the cross-rank terms enter through these
transposes. A group of None is one rank: the collectives are identities.

Gloo takes ``all_gather``, the reduce-scatter, ``gather``, ``all_reduce``
and ``all_to_all_single`` on CUDA tensors (chip_smoke.py phase 14 checks;
it refuses only the list form of ``all_to_all``, which the port does not
call), so nothing is staged through host buffers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


# torch 2.13 renames reduce_scatter_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the ranks of this rank's block of ``g`` along ``dim``:
    one reduce-scatter of ``g`` with ``dim`` moved first."""
    x = g.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                      + x.shape[1:])
    _REDUCE_SCATTER(out, x, group=group)
    return out.movedim(0, dim)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _group, _dim):
        return _gather(t, ctx.group, ctx.dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _group):
        return _exchange(t, ctx.group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    rank order; differentiable in both modes. Integer tensors go through
    too (no derivative)."""
    if group is None:
        return x
    if not x.is_floating_point():
        return _gather(x, group, dim)
    return _AllGather.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block d of ``x``'s M equal row blocks to rank d, block s of the
    result from rank s; differentiable in both modes."""
    if group is None:
        return x
    if not x.is_floating_point():
        return _exchange(x, group)
    return _AllToAll.apply(x, group)
