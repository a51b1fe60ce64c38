"""The lower-precision control comes out not correct: the plain reference
put in the program's place and computed in the precision below the
configuration's (bfloat16 for the Cornell box's float32 on the CPU; TF32
matrix products for the bunny's float32 with TF32 off, on the card only),
judged as a run of the program is, fails the cell's limits. On the card at
the cells' own sizes: ``benchmark/calibrate.py``."""
import pytest

from benchmark import calibrate
from benchmark.kinds import frames, grad

from helpers import need_card, small_cell


def _fails(cell, got):
    return any(v > cell.limits[k]["limit"] for k, v in got.items())


@pytest.mark.parametrize("seed", [3, 2**31 + 9, 77])
def test_cornell_frames_control_fails(seed):
    cell = small_cell("cornell_full.frames")
    assert calibrate.control_mode(cell) == "bfloat16"
    got = frames.control(cell, seed, "cpu", "bfloat16", window_frames=4)
    assert _fails(cell, got), got


@pytest.mark.parametrize("seed", [3, 2**31 + 9, 77])
def test_cornell_grad_control_fails(seed):
    cell = small_cell("cornell_full.grad")
    got = grad.control(cell, seed, "cpu", "bfloat16")
    assert _fails(cell, got), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bunny_glass.frames", "bunny_glass.grad"])
def test_bunny_tf32_control_fails(name):
    dev = need_card()
    cell = small_cell(name, (192, 108))
    assert calibrate.control_mode(cell) == "tf32"
    for seed in (3, 2**31 + 9, 77):
        got = (frames.control(cell, seed, dev, "tf32", window_frames=4)
               if cell.kind == "frames"
               else grad.control(cell, seed, dev, "tf32"))
        assert _fails(cell, got), got
