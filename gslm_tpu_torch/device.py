"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    With no device named and no CUDA available this raises instead of
    drifting onto the CPU; callers that want the CPU say so."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
