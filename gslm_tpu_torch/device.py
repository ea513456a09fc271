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


def platform_device(platform: str) -> torch.device:
    """The command lines' ``--platform``: "" is the card (raises without
    CUDA), "cpu" the CPU; anything else raises."""
    if platform == "":
        return resolve_device(None)
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform {platform!r}: the port runs on '' (the "
                     "CUDA card) or 'cpu'")
