"""Device selection for the port's entry points.

Every entry point runs on the card unless its caller names another device.
A host without a CUDA device raises rather than quietly falling back to the
CPU: a number measured on the CPU must never pass for one measured on the
card.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card when 0 is the current one."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)


def check_on_device(tensors, device: torch.device, what: str) -> None:
    """Raise unless every tensor lies on ``device``."""
    for t in tensors:
        if not same_device(t.device, device):
            raise ValueError(f"{what} lies on {t.device}, expected {device}")
