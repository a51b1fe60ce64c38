"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``
from the repo root): one PyTorch thread, and the ``cuda`` marker of the
tests that need a card (each decides inside the test, and skips here)."""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: requires a CUDA device (skipped where there is none)")
