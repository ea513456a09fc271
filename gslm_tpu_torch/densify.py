"""Density control (gslm_tpu/densify.py). Only the statistics the Adam step
accumulates; ``densify_and_prune`` and ``reset_opacity`` come with the
trainer loop."""

from __future__ import annotations

import torch

from gslm_tpu_torch.models.gaussians import GaussianAux


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
