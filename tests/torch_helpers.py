"""Shared setup for the PyTorch port's tests (``tests/test_torch_*.py``).

Importing this module caps PyTorch at one thread: the suite runs under
several xdist workers, and PyTorch's default of one thread per core would
oversubscribe the machine. It imports no jax, so the kernel tests can run
on a machine that has only PyTorch.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def tt(x, dtype=None) -> torch.Tensor:
    """numpy / array-like -> CPU tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def nn(x) -> np.ndarray:
    """tensor or array-like -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_rays(n: int, seed: int = 0, center=(0.0, 0.0, 3.5),
                spread: float = 0.2):
    """Rays from a jittered eye point in random directions (numpy f32)."""
    rng = np.random.default_rng(seed)
    o = np.asarray(center) + rng.normal(0, spread, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)
