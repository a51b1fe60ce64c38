"""The self-goldens through the port's megakernel on the CPU, part two:
the three bunny goldens (K1c's path on the card) and the two demo-scene
goldens (K1b's), each at least 35 dB against ``assets/goldens/<name>.png``
(``tests/test_parity.py``'s bar). ``tests/test_torch_goldens_cornell.py``
holds the Cornell four and checks every spec against
``tests/golden_specs.py``."""
import pytest

from .torch_helpers import golden_psnr


@pytest.mark.parametrize("name", ["bunny_metal", "bunny_v2",
                                  "bunny_glass_anim", "scene_demo", "tokyo"])
def test_megakernel_golden(name):
    db = golden_psnr(name)
    assert db >= 35.0, f"{name}: PSNR {db:.2f} dB"
