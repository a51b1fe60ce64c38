"""Where the port's constructors put their tensors.

Every function that makes tensors from nothing (scenes, the bunny's
weights, rays, cameras, frame states, skies, the JAX converters) takes
``device=None`` and resolves it here: None is the card. Without a card
that raises, so nothing quietly runs on the CPU; the CPU is had by asking
for it, ``device="cpu"``. Functions that are handed tensors follow those
tensors' device instead.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is ``cuda``. Raises
    RuntimeError for a CUDA device when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card unless it is "
            "given device='cpu'")
    return dev
