"""The benchmark's frozen count of a march call's work
(``metrics/work.py``) against the program's ``utils/speedlight`` on the
Cornell box and the glass bunny as they stand: the yardstick counts what
the program's own accounting counts today."""
import pytest
import torch

from benchmark import program
from benchmark.metrics import work

from helpers import small_cell


@pytest.mark.parametrize("name", ["cornell_full.frames", "bunny_glass.grad"])
@pytest.mark.parametrize("gated,resumed,mxu", [(False, True, False),
                                               (True, False, False),
                                               (True, False, True)])
def test_bound_equals_speedlight(name, gated, resumed, mxu):
    from raytracingpbr_tpu_torch.utils import speedlight
    cell = small_cell(name)
    scene, _, _, cfg = program.build(cell, 0, "cpu")
    cfg = cfg.replace(bunny_mxu=mxu)
    shapes = list(scene.shape_types)
    perms = [work.is_signed_permutation(m)
             for m in scene.matrix.cpu().tolist()]
    assert perms == [p is not None for p in scene.rot_perm]
    assert (work.flops_per_iter(shapes, perms)
            == speedlight.march_flops_per_iter(scene, cfg))
    fin = torch.arange(1000, dtype=torch.int32) % 37
    support = 4321 if scene.has_bunny else 0
    active = torch.ones(1000, dtype=torch.bool) if gated else None
    init = (tuple(torch.zeros(1000) for _ in range(4)) if resumed
            else None)
    want = speedlight.march_bound(scene, cfg, fin, support, active, init)
    got = work.march_bound(shapes, perms, 1000, int(fin.sum()), support,
                           gated, resumed, bunny_mxu=mxu)
    for k in ("flops", "bytes", "bound_ms", "bound_by"):
        assert got[k] == want[k], k
