"""Device selection shared by the port's entry points."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA;
    under a process group, the rank's card ``cuda:{LOCAL_RANK %
    device_count}`` (the global rank where ``LOCAL_RANK`` is unset).

    With no device named and no CUDA available this raises instead of
    drifting onto the CPU; callers that want the CPU say so."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        if dist.is_available() and dist.is_initialized():
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            return torch.device("cuda", local % torch.cuda.device_count())
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


def platform_backend(platform: str) -> str:
    """The ``torch.distributed`` backend of ``--platform``'s ranks: NCCL for
    the card, gloo for the CPU."""
    return "gloo" if platform_device(platform).type == "cpu" else "nccl"
