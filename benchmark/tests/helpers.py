"""Small cells for the benchmark's CPU tests: a cell of ``BENCHMARK.json``
with its resolution cut (every other setting as the configuration has it)."""
import copy

import pytest
import torch

from benchmark import harness

SIZES = {"cornell_full": (16, 16), "bunny_glass": (12, 8)}


def small_cell(name: str, size=None) -> harness.Cell:
    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.resolve(spec, name)
    cell.config = copy.deepcopy(cell.config)
    conf = name.split(".")[0]
    cell.config["render"]["resolution"] = list(size or SIZES[conf])
    cell.traffic = dict(cell.traffic, check_pixels=64)
    return cell


def need_card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
