"""General numeric helpers (the part of gslm_tpu/utils/general.py the
render path needs)."""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)
