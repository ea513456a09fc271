"""Density control (gslm_tpu/densify.py): the statistics the Adam step
accumulates, and clone / split / prune as fixed-capacity masked updates.

- *clone*: live Gaussians whose mean screen gradient reaches the threshold
  and whose largest scale is at most ``percent_dense·extent`` are copied
  into free slots.
- *split*: the larger ones get two children drawn from their own
  covariance with scales / (0.8·2); child 1 overwrites the parent's slot,
  child 2 takes a free slot, and both start with zero Adam moments.
- *prune*: opacity below the threshold, and with ``max_screen_size`` > 0
  a screen radius above it or a world scale above 0.1·extent, frees the
  slot; dead slots are parked transparent and tiny.

Requests are matched to free slots in index order; requests past the
free slots are dropped and counted (``n_dropped``) so the caller can grow
the capacity. Everything runs on the parameters'
device without a host sync.

The port updates the parameters, their ``alive`` mask and the Adam moments
in place under ``torch.no_grad()``, as ``adam_step`` does. JAX draws the
children's noise inside with ``jax.random.normal``, which torch cannot
repeat, so ``densify_and_prune`` takes it as a pair of (C, 3) tensors.
"""

from __future__ import annotations

import torch

from gslm_tpu_torch.models.gaussians import (DEAD_LOG_SCALE,
                                             DEAD_OPACITY_LOGIT, GaussianAux)
from gslm_tpu_torch.optim import AdamState, zero_state_group, zero_state_rows
from gslm_tpu_torch.utils.general import (inverse_sigmoid, quat_normalize,
                                          quat_to_rotmat)

PER_GAUSSIAN = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity")


def add_densification_stats(aux: GaussianAux, mean2d_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianAux:
    """Accumulate per-Gaussian screen-gradient norms for the visible
    Gaussians: mean2d_grad (P, 2) is the cotangent of the mean2d offset,
    radii (P,) int32 (the max over a batch's views). Returns a new aux."""
    vis = radii > 0
    g = mean2d_grad.detach()
    gnorm = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1])
    return aux.replace(
        xyz_gradient_accum=aux.xyz_gradient_accum
        + torch.where(vis, gnorm, 0.0),
        denom=aux.denom + vis.to(torch.float32),
        max_radii2d=torch.maximum(aux.max_radii2d,
                                  torch.where(vis, radii.to(torch.float32),
                                              0.0)))


def _sample_children(xyz, scaling, rotation, noise):
    """Parent centre plus ``noise`` scaled by the parent's scales and
    rotated into its frame: (C, 3)."""
    rot = quat_to_rotmat(quat_normalize(rotation))
    return xyz + torch.sum(rot * (noise * torch.exp(scaling))[:, None, :],
                           dim=-1)


@torch.no_grad()
def densify_and_prune(params, aux: GaussianAux, opt_state: AdamState, noise,
                      max_grad, min_opacity, extent, max_screen_size,
                      percent_dense):
    """One densification event. ``noise`` is ``(noise1, noise2)``, two (C, 3)
    standard normal draws for the children 1 and 2 on the parameters'
    device. The thresholds are floats or 0-d tensors, taken in float32.

    Updates ``params`` (its groups and ``alive``) and ``opt_state`` in
    place; returns ``(params, aux, opt_state, info)`` with a zeroed
    ``aux`` and ``info`` the counts n_cloned, n_split, n_pruned, n_dropped
    and n_alive as 0-d int64 tensors."""
    dev = params.xyz.device
    C = params.capacity

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    max_grad, min_opacity, extent = f32(max_grad), f32(min_opacity), f32(extent)
    max_screen_size, percent_dense = f32(max_screen_size), f32(percent_dense)
    noise1, noise2 = noise

    alive = params.alive.clone()
    grads = torch.where(aux.denom > 0, aux.xyz_gradient_accum
                        / torch.clamp(aux.denom, min=1.0), 0.0)
    max_scale = torch.amax(torch.exp(params.scaling), dim=1)
    hot = alive & (grads >= max_grad)
    small = max_scale <= percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small
    request = clone_mask | split_mask
    n_request = request.sum()
    n_free = (~alive).sum()

    # the k-th request goes to the k-th free slot (both in index order) for
    # k < n_valid; the requests past the free slots are dropped
    n_valid = torch.minimum(n_request, n_free)
    iota = torch.arange(C, device=dev)
    requests = torch.argsort(torch.where(request, iota, C))
    free_rank = torch.cumsum((~alive).to(torch.long), 0) - 1
    placed = ~alive & (free_rank < n_valid)
    src_c = requests[torch.clamp(free_rank, min=0)]   # where placed
    # split parents whose second child got a slot: child 1 takes theirs
    rank = torch.cumsum(request.to(torch.long), 0) - 1
    placed_src = split_mask & (rank < n_valid)

    # free slots take their source rows: clones verbatim, the second child
    # of a split resampled; split parents become their first child
    child1 = _sample_children(params.xyz, params.scaling, params.rotation,
                              noise1)
    child2 = _sample_children(params.xyz, params.scaling, params.rotation,
                              noise2)[src_c]
    for g in PER_GAUSSIAN:
        x = getattr(params, g)
        m = placed.reshape((-1,) + (1,) * (x.ndim - 1))
        x.copy_(torch.where(m, x[src_c], x))
    second = (placed & split_mask[src_c])[:, None]
    first = placed_src[:, None]
    params.xyz.copy_(torch.where(second, child2, torch.where(
        first, child1, params.xyz)))
    params.scaling.copy_(torch.where(
        second | first, params.scaling - torch.log(f32(0.8 * 2.0)),
        params.scaling))
    alive |= placed
    zero_state_rows(opt_state, placed | placed_src)

    # prune
    opacity = torch.sigmoid(params.opacity[:, 0])
    prune = alive & (opacity < min_opacity)
    use_screen = max_screen_size > 0
    prune |= alive & use_screen & (aux.max_radii2d > max_screen_size)
    prune |= alive & use_screen & (
        torch.amax(torch.exp(params.scaling), dim=1) > 0.1 * extent)
    alive &= ~prune

    # park dead rows at benign values; every statistic starts again
    dead = ~alive
    params.opacity.masked_fill_(dead[:, None], DEAD_OPACITY_LOGIT)
    params.scaling.masked_fill_(dead[:, None], DEAD_LOG_SCALE)
    zero_state_rows(opt_state, dead)
    params.alive.copy_(alive)

    info = {"n_cloned": clone_mask.sum(), "n_split": split_mask.sum(),
            "n_pruned": prune.sum(),
            "n_dropped": torch.clamp(n_request - n_free, min=0),
            "n_alive": alive.sum()}
    return params, GaussianAux.zeros(C, dev), opt_state, info


@torch.no_grad()
def reset_opacity(params, opt_state: AdamState):
    """opacity ← inverse_sigmoid(min(sigmoid(opacity), 0.01)) and fresh
    opacity moments, in place. Returns ``(params, opt_state)``."""
    params.opacity.copy_(inverse_sigmoid(
        torch.clamp(torch.sigmoid(params.opacity), max=0.01)))
    return params, zero_state_group(opt_state, "opacity")
