"""The port's speed-of-light accounting (``utils/speedlight.py``) and the
plain version of kernel K2 (``kernels/fma_kernel.py``).

* ``march_flops_per_iter`` equals the JAX package's for every scene and
  configuration of ``models/``, with and without the escape bound.
* The warp accounting on hand-made trip counts: a warp executes 32 lanes
  for the trips of its longest lane.
* The support count (lane-trips inside the bunny's unit sphere, where the
  MLP runs) equals a trip-by-trip replay of the same march.
* The MLP work reports the kernel's count of evaluations beside the needed
  count, and raises where the kernel ran fewer.
* K2's plain version is the numpy recurrence, and stays within 1e-5 of a
  float64 one: the recurrence contracts, so rounding does not grow.
* What needs the card raises without one.
"""
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.utils import speedlight as jspeed
from raytracingpbr_tpu_torch.kernels import fma_kernel
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.models import demo as tdemo
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.ops import sdf as tsdf
from raytracingpbr_tpu_torch.utils import speedlight

from .test_torch_march_variants import bunny_rays
from .torch_helpers import CPU, nn, tt

# name: (JAX scene, JAX config, port scene, port config)
WORKLOADS = {
    "cornell_full": (jcornell.full_scene, jcornell.full_config,
                     tcornell.full_scene, tcornell.full_config),
    "cornell_minimal": (jcornell.minimal_scene, jcornell.minimal_config,
                        tcornell.minimal_scene, tcornell.minimal_config),
    "cornell_v2": (jcornell.v2_scene, jcornell.v2_config,
                   tcornell.v2_scene, tcornell.v2_config),
    "cornell_v3": (jcornell.full_scene, jcornell.v3_config,
                   tcornell.full_scene, tcornell.v3_config),
    "engine": (jdemo.engine_scene, jdemo.engine_config,
               tdemo.engine_scene, tdemo.engine_config),
    "scene_demo": (jdemo.scene_demo_scene, jdemo.scene_demo_config,
                   tdemo.scene_demo_scene, tdemo.scene_demo_config),
    "tokyo": (jdemo.scene_demo_scene, jdemo.tokyo_config,
              tdemo.scene_demo_scene, tdemo.tokyo_config),
    "bunny_metal": (jbunny.metal_scene, jbunny.metal_config,
                    tbunny.metal_scene, tbunny.metal_config),
    "bunny_glass": (jbunny.glass_scene, jbunny.glass_config,
                    tbunny.glass_scene, tbunny.glass_config),
    "bunny_glass_animated": (
        lambda: jbunny.animated_scene(jbunny.glass_scene(), 12),
        jbunny.glass_config,
        lambda device: tbunny.animated_scene(tbunny.glass_scene(device), 12),
        tbunny.glass_config),
}


@pytest.mark.parametrize("escape_bound", [False, True])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_flops_per_iter_matches_jax(name, escape_bound):
    jscene, jcfg, tscene, tcfg = WORKLOADS[name]
    ref = jspeed.march_flops_per_iter(
        jscene(), jcfg().replace(escape_bound=escape_bound))
    got = speedlight.march_flops_per_iter(
        tscene(CPU), tcfg().replace(escape_bound=escape_bound))
    assert got == ref


def test_bunny_flop_split():
    """The MLP part of a bunny lane-trip is all but its support test, and
    K1d's tensor-core part is the two 16 x 16 contractions."""
    assert speedlight.BUNNY_MLP_FLOPS + 8 == jspeed._BUNNY_FLOPS
    assert speedlight.BUNNY_CONTRACTION_FLOPS == 1024


def test_warp_accounting_and_bound_on_hand_made_fin():
    # warp 0 idle, warp 1 mixed (longest lane 90), warp 2 ragged (3 lanes)
    fin = torch.tensor([0] * 32 + [50] * 31 + [90] + [30, 10, 20],
                       dtype=torch.int32)
    assert speedlight.warp_executed(fin) == 32 * 0 + 32 * 90 + 32 * 30
    scene, cfg = tcornell.full_scene(CPU), tcornell.full_config()
    b = speedlight.march_bound(scene, cfg, fin, support=0)
    needed = 50 * 31 + 90 + 60
    assert b["lane_iters_needed"] == needed
    assert b["flops"] == needed * speedlight.march_flops_per_iter(scene, cfg)
    assert b["bytes"] == fin.shape[0] * (24 + 29)
    ops_ms = b["flops"] / speedlight.H100_FP32_FLOPS * 1e3
    assert b["bound_ms"] == pytest.approx(ops_ms)
    assert b["bound_by"] == "operations"
    # nothing needed: the bytes bound it; gate and resume inputs count
    idle = speedlight.march_bound(scene, cfg, torch.zeros_like(fin), 0,
                                  active=fin > 0, init=(fin,) * 4)
    assert idle["bound_by"] == "bytes"
    assert idle["bytes"] == fin.shape[0] * (24 + 29 + 1 + 16)


def test_bunny_bound_counts_the_mlp_inside_only():
    scene, cfg = tbunny.glass_scene(CPU), tbunny.glass_config()
    fin = torch.full((64,), 10, dtype=torch.int32)
    fpi = speedlight.march_flops_per_iter(scene, cfg)
    outside = speedlight.march_bound(scene, cfg, fin, support=0)
    assert outside["flops"] == 640 * (fpi - speedlight.BUNNY_MLP_FLOPS)
    inside = speedlight.march_bound(scene, cfg, fin, support=640)
    assert inside["flops"] == 640 * fpi
    tc = speedlight.march_bound(scene, cfg.replace(bunny_mxu=True), fin,
                                support=640)
    assert tc["tensor_core_flops"] == 640 * 1024
    assert tc["bound_ms"] < inside["bound_ms"]


def test_support_count_equals_trip_by_trip_replay():
    """The plain march's count of lane-trips inside the unit sphere, against
    chained one-trip resumes (bit-identical to one march) whose points are
    tested one trip at a time."""
    scene = tbunny.glass_scene(CPU)
    cfg = tbunny.glass_config(scale=8).replace(max_raymarch=12)
    o, d = (tt(v) for v in bunny_rays(n=256, seed=2))
    inside, warp_inside = speedlight.support_lane_trips(scene, o, d, cfg)
    live = torch.ones(o.shape[0], dtype=torch.bool)
    init, count = None, 0
    for _ in range(cfg.max_raymarch):
        t = init[0] if init else torch.full((256,), cfg.march_t0)
        p = tsdf.to_object_space(o + t[:, None] * d, scene.position[0],
                                 scene.matrix[0], scene.local_offset[0])
        r = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
                       + p[:, 2] * p[:, 2])
        count += int((live & ~(r > 1.0)).sum())
        rr = tmarch.march_resumable_plain(scene, o, d,
                                          cfg.replace(max_raymarch=1),
                                          active=live, init=init)
        live = live & (rr.done == 0)
        init = (rr.t, rr.w, rr.s, rr.d)
    assert inside == count > 0
    assert warp_inside % 32 == 0 and inside <= warp_inside
    # rays that point away from the bunny never enter its sphere
    none = speedlight.support_lane_trips(scene, o, -d, cfg)
    assert none == (0, 0)
    assert speedlight.support_lane_trips(tcornell.full_scene(CPU), o, d,
                                         cfg) == (0, 0)


def test_mlp_work_reports_executed_beside_support():
    """The kernel's MLP count is reported beside the needed count. By hand:
    rays straight down the z axis into the bunny's sphere from z = 1.5 at
    t0 = 0.25, omega 0.5 and a distance of r - 0.8 outside it: z = 1.25,
    1.025, 0.9125 (inside from the third trip), so 3 lanes x budget 4 need
    3 x 2 MLP trips; two block-rounds of 3 entries, padded to whole warps,
    run 64."""
    scene = tbunny.glass_scene(CPU)
    cfg = tbunny.glass_config().replace(max_raymarch=4, march_t0=0.25)
    o = tt(np.tile([[0.0, 0.0, 1.5]], (3, 1)).astype(np.float32))
    d = tt(np.tile([[0.0, 0.0, -1.0]], (3, 1)).astype(np.float32))
    support, warp_support = speedlight.support_lane_trips(scene, o, d, cfg)
    assert (support, warp_support) == (6, 64)
    w = speedlight.mlp_work(support, 64)
    assert w["support_lane_iters"] == 6
    assert w["mlp_lane_iters_executed"] == 64
    assert w["mlp_padding_pct"] == pytest.approx(100.0 * (64 / 6 - 1))
    assert speedlight.mlp_work(0, 0)["mlp_padding_pct"] == 0.0
    with pytest.raises(AssertionError, match="5 MLP evaluations for 6"):
        speedlight.mlp_work(support, 5)


@pytest.mark.parametrize("chains,unroll", fma_kernel.SHAPES)
def test_fma_plain_is_the_recurrence(chains, unroll):
    x = np.random.default_rng(chains).uniform(0, 1, 257).astype(np.float32)
    iters = 24
    before = dict(fma_kernel.LAUNCHES)
    got = nn(fma_kernel.fma_chains(tt(x), iters, chains, unroll))
    assert fma_kernel.LAUNCHES == before  # CPU tensors: the plain version
    f = np.float32
    acc = [x * f(1.0 + 0.001 * k) for k in range(chains)]
    a = x * f(0.25) + f(0.5)
    for _ in range(iters * unroll):
        acc = [v * a + f(0.125) for v in acc]
    np.testing.assert_array_equal(got, _left_sum(acc))
    # against float64: the recurrence contracts towards 0.125 / (1 - a),
    # so single and double rounding stay within K2's bar of rtol 1e-5
    x64 = x.astype(np.float64)
    acc = [x64 * (1.0 + 0.001 * k) for k in range(chains)]
    a = x64 * 0.25 + 0.5
    for _ in range(iters * unroll):
        acc = [v * a + 0.125 for v in acc]
    np.testing.assert_allclose(got, _left_sum(acc), rtol=1e-5)


def _left_sum(vs):
    out = vs[0]
    for v in vs[1:]:
        out = out + v
    return out


def test_card_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_kernel.py runs K2")
    speedlight.fma_sweep.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        speedlight.measure_vpu_peak()
    scene, cfg = tcornell.full_scene(CPU), tcornell.full_config()
    o, d = tt(np.zeros((4, 3), np.float32)), tt(np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        speedlight.march_utilization(scene, o, d, cfg)
