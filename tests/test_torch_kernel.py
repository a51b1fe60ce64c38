"""The CUDA kernels against their plain PyTorch versions on the card.

Built with -fmad=false and without fast math, the march kernels K1a-K1c
round every add and multiply as PyTorch's elementwise CUDA ops do, in the
same order, so all eight outputs must be bit-equal (K1c's ``sinf`` is
libdevice's, as ``torch.sin``'s is on the card). K1d runs the bunny MLP's
contractions on the tensor cores in another summation order than the
plain version's matmuls, so it is held to the reference's march bars
(``ops/march.assert_march_close``: at least 99.9% of lanes agree on hit,
equal index where both hit, t within rtol and atol 1e-3 where hit agrees
save a decision one trip apart and at most one grazing lane in
10,000), and its MLP alone to 1e-6 of a float64 evaluation. K2's FFMA
rounds once where the plain version's multiply and add round twice: rtol
1e-5. These tests need a CUDA device and skip without one; this file
imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch.config import HitCriterion, OmegaPolicy
from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.kernels import fma_kernel, march_kernel
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.ops import camera as tcamera
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.ops.scene import ObjectSpec, make_scene
from raytracingpbr_tpu_torch.ops.sdf import SHAPE, BunnyMLP, bunny_mlp_eval

from .torch_helpers import cuda_device, random_rays  # noqa: F401

pytestmark = pytest.mark.cuda

FIELDS = ("t", "index", "hit", "fin", "w", "s", "d", "done")


def primaries(cfg, device):
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=device)
    u = trng.uniform4(pid, 0, 1, cfg.seed)
    uv = tcamera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = tcamera.get_ray(cornell.full_camera(device), uv, u[2], u[3])
    return rays.origin, rays.direction


def assert_bit_equal(a, b):
    for name, x, y in zip(FIELDS, a, b):
        assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
        assert torch.equal(x, y), (
            f"{name}: {int((x != y).sum())} lanes differ")


def both(scene, o, d, cfg, active=None, init=None):
    kind = march_kernel.variant(scene, cfg)
    before = march_kernel.LAUNCHES[kind]
    k = tmarch.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=active, init=init))
    assert march_kernel.LAUNCHES[kind] == before + (1 if o.shape[0] else 0)
    p = tmarch.march_resumable_plain(scene, o, d, cfg, active=active,
                                     init=init)
    return k, p


def test_primaries_chained_budget(cuda_device):
    scene = cornell.full_scene(cuda_device)
    cfg = cornell.full_config().replace(resolution=(96, 96))
    o, d = primaries(cfg, cuda_device)
    mcfg = cfg.replace(max_raymarch=32)
    live = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    init = None
    for _ in range(cfg.max_raymarch // 32):
        k, p = both(scene, o, d, mcfg, active=live, init=init)
        assert_bit_equal(k, p)
        live = live & (k.done == 0)
        init = (k.t, k.w, k.s, k.d)
        if not bool(live.any()):
            break
    # the wavefront dispatch goes through the kernel on CUDA tensors
    before = march_kernel.LAUNCHES["k1a"]
    tmarch.march_resumable(scene, o, d, mcfg)
    assert march_kernel.LAUNCHES["k1a"] == before + 1


@pytest.mark.parametrize("n", [0, 1, 255, 257, 4097])
def test_ragged_and_gated(cuda_device, n):
    scene = cornell.full_scene(cuda_device)
    cfg = cornell.full_config().replace(max_raymarch=64)
    o, d = (torch.as_tensor(v, device=cuda_device)
            for v in random_rays(n, seed=n, center=(0.0, 0.0, 0.5),
                                 spread=0.3))
    k, p = both(scene, o, d, cfg)
    assert_bit_equal(k, p)
    rng = np.random.default_rng(n)
    active = torch.as_tensor(rng.random(n) < 0.5, device=cuda_device)
    init = tuple(torch.as_tensor(rng.uniform(0.01, 1.0, n).astype(np.float32),
                                 device=cuda_device) for _ in range(4))
    k, p = both(scene, o, d, cfg, active=active, init=init)
    assert_bit_equal(k, p)
    k, p = both(scene, o, d, cfg, active=torch.zeros_like(active))
    assert_bit_equal(k, p)


def test_all_analytic_shapes(cuda_device):
    objs = [
        ObjectSpec(SHAPE.PLANE, (0, -1.2, 0), (0, 0, 0), (1, 0.0, 1)),
        ObjectSpec(SHAPE.SPHERE, (0.4, 0.1, -0.3), (0, 0, 0), (0.35,) * 3),
        ObjectSpec(SHAPE.BOX, (-0.5, -0.2, 0.1), (10, 35, -20),
                   (0.3, 0.2, 0.25)),
        ObjectSpec(SHAPE.CYLINDER, (0.9, -0.4, 0.5), (0, 0, 30),
                   (0.2, 0.4, 0.2)),
        ObjectSpec(SHAPE.CONE, (-0.2, 0.4, -0.6), (15, 0, 0),
                   (0.8, 0.6, 0.6)),
        ObjectSpec(SHAPE.NONE),
    ]
    scene = make_scene(objs, box_round=0.03, device=cuda_device)
    cfg = cornell.full_config().replace(max_raymarch=128)
    o, d = (torch.as_tensor(v, device=cuda_device)
            for v in random_rays(8192, seed=3))
    k, p = both(scene, o, d, cfg)
    assert_bit_equal(k, p)
    assert bool(k.hit.any())


def _rays(n, seed, center, spread, device):
    return tuple(torch.as_tensor(v, device=device)
                 for v in random_rays(n, seed=seed, center=center,
                                      spread=spread))


def _gated_resumed(scene, o, d, cfg, seed):
    """Fresh, gated and resumed calls, each bit-equal."""
    n = o.shape[0]
    k, p = both(scene, o, d, cfg)
    assert_bit_equal(k, p)
    rng = np.random.default_rng(seed)
    active = torch.as_tensor(rng.random(n) < 0.5, device=o.device)
    k, p = both(scene, o, d, cfg, active=active, init=(k.t, k.w, k.s, k.d))
    assert_bit_equal(k, p)
    k, p = both(scene, o, d, cfg, active=torch.zeros_like(active))
    assert_bit_equal(k, p)


K1B_CASES = {
    "engine": (demo.engine_scene, demo.engine_config),
    "scene_demo": (demo.scene_demo_scene, demo.scene_demo_config),
    "tokyo": (demo.engine_scene, demo.tokyo_config),
    "engine_bound": (demo.engine_scene,
                     lambda: demo.engine_config().replace(escape_bound=True)),
    "cornell_v3": (cornell.full_scene, cornell.v3_config),
}


@pytest.mark.parametrize("case", sorted(K1B_CASES))
def test_k1b_variants(cuda_device, case):
    make_scene_fn, make_cfg = K1B_CASES[case]
    scene = make_scene_fn(device=cuda_device)
    cfg = make_cfg().replace(max_raymarch=128)
    assert march_kernel.variant(scene, cfg) == "k1b"
    o, d = _rays(8192, 4, (0.0, 0.0, 3.5), 0.3, cuda_device)
    _gated_resumed(scene, o, d, cfg, seed=4)


BUNNY_CASES = {
    "glass": (bunny.glass_scene, bunny.glass_config),
    "metal": (bunny.metal_scene, bunny.metal_config),
    "animated": (lambda device: bunny.animated_scene(
        bunny.glass_scene(device), 60), bunny.glass_config),
    "glass_bound": (bunny.glass_scene, lambda s: bunny.glass_config(
        s).replace(escape_bound=True)),
}


@pytest.mark.parametrize("case", sorted(BUNNY_CASES))
def test_k1c_bunny(cuda_device, case):
    make_scene_fn, make_cfg = BUNNY_CASES[case]
    scene = make_scene_fn(device=cuda_device)
    cfg = make_cfg(8).replace(max_raymarch=64)
    assert march_kernel.variant(scene, cfg) == "k1c"
    # camera primaries, then rays aimed at the bunny with a spread
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=cuda_device)
    u = trng.uniform4(pid, 0, 1, cfg.seed)
    uv = tcamera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = tcamera.get_ray(bunny.camera(cfg.width / cfg.height, cuda_device),
                           uv, u[2], u[3])
    _gated_resumed(scene, rays.origin, rays.direction, cfg, seed=1)
    o, d = _rays(4096, 3, (0.0, 0.0, 2.5), 0.1, cuda_device)
    d = -o + 0.35 * torch.randn(o.shape, generator=torch.Generator(
        cuda_device).manual_seed(3), device=cuda_device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    k, p = both(scene, o, d, cfg)
    assert_bit_equal(k, p)
    assert bool(k.hit.any())


@pytest.mark.parametrize("n", [0, 1, 255, 257, 4097])
def test_k1c_ragged_gated_resumed(cuda_device, n):
    scene = bunny.glass_scene(cuda_device)
    cfg = bunny.glass_config(8).replace(max_raymarch=32)
    o, d = _rays(n, n, (0.0, 0.0, 2.0), 0.5, cuda_device)
    _gated_resumed(scene, o, d, cfg, seed=n)


def test_bunny_mxu_raises_naming_k1d(cuda_device):
    """cfg.bunny_mxu no longer raises: the dispatch sends it to K1d."""
    scene = bunny.glass_scene(cuda_device)
    cfg = bunny.glass_config(8).replace(bunny_mxu=True)
    assert march_kernel.variant(scene, cfg) == "k1d"
    o, d = _rays(16, 0, (0.0, 0.0, 2.5), 0.1, cuda_device)
    before = dict(march_kernel.LAUNCHES)
    tmarch.march_resumable(scene, o, d, cfg)
    before["k1d"] += 1
    assert march_kernel.LAUNCHES == before


def both_close(scene, o, d, cfg, active=None, init=None):
    """K1d and its plain version on the same inputs, held to the port's
    march bar (``ops/march.assert_march_close``)."""
    k, p = both(scene, o, d, cfg, active=active, init=init)
    tmarch.assert_march_close(scene, o, d, k, p, cfg)
    return k


def _k1d_gated_resumed(scene, o, d, cfg, seed):
    n = o.shape[0]
    k = both_close(scene, o, d, cfg)
    rng = np.random.default_rng(seed)
    active = torch.as_tensor(rng.random(n) < 0.5, device=o.device)
    both_close(scene, o, d, cfg, active=active, init=(k.t, k.w, k.s, k.d))
    k = both_close(scene, o, d, cfg, active=torch.zeros_like(active))
    assert int(k.fin.sum()) == 0


@pytest.mark.parametrize("case", sorted(BUNNY_CASES))
def test_k1d_bunny(cuda_device, case):
    make_scene_fn, make_cfg = BUNNY_CASES[case]
    scene = make_scene_fn(device=cuda_device)
    cfg = make_cfg(8).replace(max_raymarch=64, bunny_mxu=True)
    assert march_kernel.variant(scene, cfg) == "k1d"
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=cuda_device)
    u = trng.uniform4(pid, 0, 1, cfg.seed)
    uv = tcamera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = tcamera.get_ray(bunny.camera(cfg.width / cfg.height, cuda_device),
                           uv, u[2], u[3])
    _k1d_gated_resumed(scene, rays.origin, rays.direction, cfg, seed=1)
    o, d = _rays(4096, 3, (0.0, 0.0, 2.5), 0.1, cuda_device)
    d = -o + 0.35 * torch.randn(o.shape, generator=torch.Generator(
        cuda_device).manual_seed(3), device=cuda_device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    k = both_close(scene, o, d, cfg)
    assert bool(k.hit.any())


K1D_POLICIES = {
    "rollback_cone": dict(omega=1.6, omega_policy=OmegaPolicy.ROLLBACK_TO_ONE,
                          hit_criterion=HitCriterion.CONE),
    "half_up_relative": dict(omega=1.6,
                             omega_policy=OmegaPolicy.ROLLBACK_HALF_UP,
                             hit_criterion=HitCriterion.RELATIVE),
    "absolute_bound": dict(omega=1.0, hit_criterion=HitCriterion.ABSOLUTE,
                           hit_precision=1e-4, escape_bound=True),
}


@pytest.mark.parametrize("case", sorted(K1D_POLICIES))
def test_k1d_policies_and_hit_tests(cuda_device, case):
    scene = bunny.glass_scene(cuda_device)
    cfg = bunny.glass_config(8).replace(max_raymarch=64, bunny_mxu=True,
                                        **K1D_POLICIES[case])
    # 2^15 rays: the bar lets one grazing lane in 10,000 part in t
    o, d = _rays(1 << 15, 5, (0.0, 0.0, 2.0), 0.5, cuda_device)
    _k1d_gated_resumed(scene, o, d, cfg, seed=5)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 4097])
def test_k1d_ragged_gated_resumed(cuda_device, n):
    scene = bunny.metal_scene(cuda_device)
    cfg = bunny.metal_config(8).replace(max_raymarch=32, bunny_mxu=True)
    o, d = _rays(n, n, (0.0, 0.0, 2.0), 0.5, cuda_device)
    _k1d_gated_resumed(scene, o, d, cfg, seed=n)


def unit_ball(n, seed, device):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p *= rng.uniform(0, 1, (n, 1)) ** (1 / 3) / np.linalg.norm(
        p, axis=-1, keepdims=True)
    return torch.as_tensor(p.astype(np.float32), device=device)


def test_k1d_mlp_within_1e6_of_float64(cuda_device):
    scene = bunny.glass_scene(cuda_device)
    p = unit_ball(1 << 20, 0, cuda_device)
    got = march_kernel.bunny_mlp_mxu(scene, p)
    mlp64 = BunnyMLP(*(v.double() for v in scene.bunny))
    ref = bunny_mlp_eval(mlp64, p.double())
    err = float((got.double() - ref).abs().max())
    assert err < 1e-6, err
    # a ragged count runs the same MLP
    torch.testing.assert_close(march_kernel.bunny_mlp_mxu(scene, p[:33]),
                               got[:33], rtol=0, atol=0)


@pytest.mark.parametrize("chains,unroll", fma_kernel.SHAPES)
def test_k2_matches_plain(cuda_device, chains, unroll):
    x = torch.rand(132 * 256 + 3, generator=torch.Generator().manual_seed(
        chains), dtype=torch.float32).to(cuda_device)
    before = fma_kernel.LAUNCHES["k2"]
    got = fma_kernel.fma_chains(x, 64, chains, unroll)
    assert fma_kernel.LAUNCHES["k2"] == before + 1
    ref = fma_kernel.fma_chains_plain(x, 64, chains, unroll)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
