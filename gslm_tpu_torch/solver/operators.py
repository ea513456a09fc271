"""Matrix-free Jacobian operators over the render + residual pipeline
(gslm_tpu/solver/operators.py).

The whole pipeline is a residual function r(θ) of the parameter groups,
and

    J·v  = forward-mode AD of r at θ along v (``torch.autograd.forward_ad``
           under ``torch.no_grad``: no autograd graph is kept; the
           compositor runs kernel E, the SSIM blur kernel B's JVP)
    Jᵀ·u = reverse-mode AD through ONE linearization, the residual forward
           run once with autograd when the operators are built; every Jᵀ·u
           is a ``torch.autograd.grad`` with ``retain_graph=True`` (the
           compositor's backward is kernel C)

so one residual function serves both: the port needs no forward-mode twin
of it (JAX's ``residual_fn_jvp``). Micro-batching over views
(``chunked_residual_fn``) lives inside the residual function. The group
and alive masks are applied to tangents and cotangents.

Parameter-space vectors are ``{group: tensor}`` dicts, residual-space ones
``ResidualState``s.

``axis_name="data"``: the residuals' views are split over the data axis's
ranks (``parallel``) while the parameters are replicated. Residual-space
dots, the loss and every Jᵀ·u (after ``torch.autograd.grad``, one flat
buffer per collective) are summed over the ranks; parameter-space dots and
J·v stay local. ``param_axis="model"`` (with the ``mesh`` that has it): the
per-Gaussian groups are this rank's shard of the model axis and the
residuals its tile-row band. Residual dots and the loss are summed over
both axes, parameter dots go through ``vdot_sharded`` (exposure counted
once), and Jᵀ·u sums only the exposure leaf over the model axis before the
data axis's sum; the per-Gaussian cotangents are already owner-resident
through the exchange's transpose. Jᵀ·u reuses one retained graph, and every
backward through it replays the exchange's reverse collectives, so every
rank of a model group calls J·v and Jᵀ·u the same number of times, in the
same order (CGLS's scalars are all-reduced, so its branches agree).
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from gslm_tpu_torch.models import gaussians as G
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
from gslm_tpu_torch.parallel.mesh import (all_reduce, all_reduce_dict,
                                          axis_group)
from gslm_tpu_torch.solver.residuals import (ResidualState, res_dot,
                                             res_map, res_saxpy)


def _mask_fn(group_mask: dict[str, float] | None,
             alive: torch.Tensor | None):
    def apply(v: dict) -> dict:
        if group_mask is not None:
            v = G.apply_group_mask(v, group_mask)
        if alive is not None:
            v = G.apply_splat_mask(v, alive)
        return v
    return apply


def _tangent(x: torch.Tensor) -> torch.Tensor:
    t = fwAD.unpack_dual(x).tangent
    return torch.zeros_like(x) if t is None else t


class LMOperators:
    """(matvec, matvec_T, dots, saxpys) around a residual function and a
    parameter point. Building one runs one linearizing forward."""

    def __init__(self, residual_fn: Callable[..., ResidualState], params,
                 group_mask: dict[str, float] | None = None,
                 alive: torch.Tensor | None = None,
                 reuse_linearization: bool = True,
                 axis_name: str | None = None,
                 param_axis: str | None = None, mesh=None):
        """``residual_fn`` takes renderable parameters (``GaussianParams``
        or ``GaussianTensors``); ``params`` is the linearization point.
        ``mesh`` (``parallel.Mesh``) resolves the axis names; without one
        only ``axis_name="data"`` exists, over the world group."""
        self._group = None if axis_name is None else axis_group(axis_name,
                                                                mesh)
        self._pgroup = None if param_axis is None else axis_group(param_axis,
                                                                  mesh)
        axes = tuple(x for x in (axis_name, param_axis) if x)
        # residuals lie on every axis given
        self._rgroup = axis_group(axes if len(axes) > 1 else axes[0],
                                  mesh) if axes else None
        if axes:
            # bind the collective-aware dot (the static one stays for the
            # single process)
            self.dot = functools.partial(self._dot_axis, self._rgroup,
                                         param_axis is not None,
                                         self._pgroup)
        self.residual_fn = residual_fn
        self.params = params
        self._primal = params.groups()
        self._mask = _mask_fn(group_mask, alive)
        if reuse_linearization:
            self._leaves, self._lin = self._linearize()
            self.residual = res_map(torch.Tensor.detach, self._lin)
        else:
            self._leaves = self._lin = None
            with torch.no_grad():
                self.residual = residual_fn(params)

    def _linearize(self):
        leaves = {g: x.clone().requires_grad_(True)
                  for g, x in self._primal.items()}
        with torch.enable_grad():
            r = self.residual_fn(G.with_groups(self.params, leaves))
        return leaves, r

    # -- operator protocol (reference solver_functions.py:83-138) --------
    def matvec(self, v: dict) -> ResidualState:
        """J·v by forward mode."""
        v = self._mask(v)
        with torch.no_grad(), fwAD.dual_level():
            duals = {g: fwAD.make_dual(self._primal[g], v[g])
                     for g in PARAM_GROUPS}
            r = self.residual_fn(G.with_groups(self.params, duals))
            return res_map(_tangent, r)

    def matvec_T(self, u: ResidualState) -> dict:
        """Jᵀ·u by reverse mode through the retained linearization."""
        if self._lin is not None:
            leaves, lin, retain = self._leaves, self._lin, True
        else:
            (leaves, lin), retain = self._linearize(), False
        if lin.ssim is lin.l1:
            outs, cots = [lin.l1], [u.l1 + u.ssim]
        else:
            outs, cots = [lin.l1, lin.ssim], [u.l1, u.ssim]
        found = torch.autograd.grad(outs, [leaves[g] for g in PARAM_GROUPS],
                                    cots, retain_graph=retain,
                                    allow_unused=True)
        g = {name: torch.zeros_like(leaves[name]) if d is None else d
             for name, d in zip(PARAM_GROUPS, found)}
        if self._pgroup is not None:
            # the replicated exposure's partials lie on every band
            g["exposure"] = all_reduce([g["exposure"]], "sum",
                                       self._pgroup)[0]
        if self._group is not None:
            # the ranks' views differ: sum their partials
            g = all_reduce_dict(g, "sum", self._group)
        return self._mask(g)

    def get_initial_solution(self) -> dict:
        return G.zeros_like_params(self.params)

    @property
    def loss_scalar(self) -> torch.Tensor:
        if self._rgroup is not None:
            return all_reduce([self.residual.loss_scalar], "sum",
                              self._rgroup)[0]
        return self.residual.loss_scalar

    # -- generalized vector algebra, dispatching on space -----------------
    @staticmethod
    def dot(a, b, damp=1.0):
        if isinstance(a, ResidualState):
            assert damp == 1.0 or not isinstance(damp, dict)
            return res_dot(a, b) * (1.0 if damp == 1.0 else damp)
        return G.vdot(a, b, damp)

    @staticmethod
    def _dot_axis(rgroup, sharded: bool, pgroup, a, b, damp=1.0):
        if isinstance(a, ResidualState):
            return all_reduce([LMOperators.dot(a, b, damp)], "sum",
                              rgroup)[0]
        if sharded:
            return G.vdot_sharded(a, b, damp, pgroup)
        return G.vdot(a, b, damp)      # replicated parameters: no collective

    @staticmethod
    def saxpy(alpha, x, y):
        if isinstance(x, ResidualState):
            return res_saxpy(alpha, x, y)
        return G.saxpy(alpha, x, y)

    @staticmethod
    def dampmul_for(damp: dict[str, float]):
        """D·x for a per-group damping dict (GaussianModelDampMatrix
        analog)."""
        def dampmul(x: dict) -> dict:
            return {g: x[g] * damp[g] for g in PARAM_GROUPS}
        return dampmul


def chunked_residual_fn(residual_of_batch: Callable, cameras_stacked,
                        chunk_size: int, view_valid: torch.Tensor | None = None):
    """Micro-batch a residual function over the view axis.

    ``cameras_stacked``: a CameraBatch whose B views are a multiple of
    ``chunk_size`` (pad views; zero the pads with ``view_valid``, (B,) f32
    weights multiplied into the residuals). Returns r(θ) evaluating the
    chunks one after another, so a render's working set is one chunk's.

    When autograd records, each chunk runs under ``torch.utils.checkpoint``
    (JAX's ``jax.checkpoint`` of the chunk body): only the chunk inputs are
    saved and every backward replays the chunk's forward. Under
    ``torch.no_grad`` (J·v, validation renders) nothing is saved and the
    chunk runs directly; forward-mode tangents flow through it."""
    nviews = cameras_stacked.batch_size
    if nviews % chunk_size:
        raise ValueError(f"{nviews} views do not split into chunks of "
                         f"{chunk_size}")
    chunks = [cameras_stacked.take(slice(i, i + chunk_size))
              for i in range(0, nviews, chunk_size)]
    weights = (None if view_valid is None
               else view_valid.reshape(-1, chunk_size))

    def one(params, cams, w):
        r = residual_of_batch(params, cams)
        if w is not None:
            r = res_map(lambda x: x * w[:, None, None, None], r)
        return r.l1, r.ssim

    def residual_fn(params) -> ResidualState:
        outs = []
        for i, cams in enumerate(chunks):
            w = None if weights is None else weights[i]
            if torch.is_grad_enabled():
                outs.append(checkpoint(one, params, cams, w,
                                       use_reentrant=False))
            else:
                outs.append(one(params, cams, w))
        return ResidualState(l1=torch.cat([o[0] for o in outs]),
                             ssim=torch.cat([o[1] for o in outs]))

    return residual_fn
