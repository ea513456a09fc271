"""Per-group Adam for the Gaussian parameters (gslm_tpu/optim.py).

One Adam over the seven parameter groups with per-group learning rates
(xyz and exposure scheduled by step), the JAX update written as it is,
``lr * (mu / bc1) / (sqrt(nu / bc2) + eps)`` with eps = 1e-15 for the
Gaussian groups and 1e-8 for exposure, and the ``visible`` mask of sparse
Adam (only rows with radii > 0 this step get moments and an update).
``torch.optim.Adam`` is not used: it places sqrt(bc2) elsewhere, so it
rounds differently, and it has no visibility mask.

Moments and gradients are dictionaries keyed by group name. ``adam_step``
updates the parameters and moments in place under ``torch.no_grad()``
(the JAX version returns new arrays), which saves the copies; so do
``zero_state_rows`` and ``zero_state_group``, densification's fixed-capacity
form of optimizer surgery.
"""

from __future__ import annotations

import dataclasses

import torch

from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianParams,
                                             zeros_like_params)
from gslm_tpu_torch.struct import Struct
from gslm_tpu_torch.utils.general import expon_lr
from gslm_tpu_torch.utils.profiling import span

BETA1, BETA2 = 0.9, 0.999
EPS = {g: 1e-15 for g in PARAM_GROUPS} | {"exposure": 1e-8}


@dataclasses.dataclass
class AdamState(Struct):
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    step: int


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(mu=zeros_like_params(params),
                     nu=zeros_like_params(params), step=0)


def group_learning_rates(opt_cfg, step, spatial_lr_scale: float) -> dict:
    """Per-group learning rates at ``step``: float32 0-d tensors for the
    scheduled groups (xyz, exposure), Python floats for the others."""
    return {
        "xyz": expon_lr(step,
                        opt_cfg.position_lr_init * spatial_lr_scale,
                        opt_cfg.position_lr_final * spatial_lr_scale,
                        lr_delay_mult=opt_cfg.position_lr_delay_mult,
                        max_steps=opt_cfg.position_lr_max_steps),
        "features_dc": opt_cfg.feature_lr,
        "features_rest": opt_cfg.feature_lr / 20.0,
        "opacity": opt_cfg.opacity_lr,
        "scaling": opt_cfg.scaling_lr,
        "rotation": opt_cfg.rotation_lr,
        "exposure": expon_lr(step, opt_cfg.exposure_lr_init,
                             opt_cfg.exposure_lr_final,
                             lr_delay_steps=opt_cfg.exposure_lr_delay_steps,
                             lr_delay_mult=opt_cfg.exposure_lr_delay_mult,
                             max_steps=opt_cfg.iterations),
    }


@torch.no_grad()
def adam_step(params: GaussianParams, grads: dict[str, torch.Tensor],
              state: AdamState, lrs: dict,
              visible: torch.Tensor | None = None
              ) -> tuple[GaussianParams, AdamState]:
    """One Adam update, in place. ``visible`` (C,) bool restricts the
    per-Gaussian rows (sparse Adam); exposure is always dense. Returns the
    same ``params`` and ``state`` objects, updated."""
    t = state.step + 1
    # float32 0-d CPU tensors, as the learning rates: they enter CUDA ops as
    # scalars
    bc1 = 1.0 - torch.tensor(BETA1) ** t
    bc2 = 1.0 - torch.tensor(BETA2) ** t
    with span("gslm.adam"):
        for g in PARAM_GROUPS:
            p = getattr(params, g)
            gr = grads[g]
            mu, nu = state.mu[g], state.nu[g]
            mu_n = BETA1 * mu + (1 - BETA1) * gr
            nu_n = BETA2 * nu + (1 - BETA2) * gr * gr
            upd = lrs[g] * (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + EPS[g])
            p_n = p - upd
            if visible is not None and g != "exposure":
                m = visible.reshape((-1,) + (1,) * (p.ndim - 1))
                p_n = torch.where(m, p_n, p)
                mu_n = torch.where(m, mu_n, mu)
                nu_n = torch.where(m, nu_n, nu)
            p.copy_(p_n)
            mu.copy_(mu_n)
            nu.copy_(nu_n)
    state.step = t
    return params, state


@torch.no_grad()
def zero_state_rows(state: AdamState, rows: torch.Tensor,
                    groups=tuple(g for g in PARAM_GROUPS if g != "exposure")
                    ) -> AdamState:
    """Zero the moment rows of the (C,) bool mask ``rows`` in the given
    groups, in place. Returns ``state``."""
    for g in groups:
        m = rows.reshape((-1,) + (1,) * (state.mu[g].ndim - 1))
        for moments in (state.mu, state.nu):
            moments[g].masked_fill_(m, 0.0)
    return state


@torch.no_grad()
def zero_state_group(state: AdamState, group: str) -> AdamState:
    """Zero a whole group's moments, in place. Returns ``state``."""
    state.mu[group].zero_()
    state.nu[group].zero_()
    return state
