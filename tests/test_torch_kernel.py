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
1e-5. The counter RNG's kernel (``csrc/rng.cu``) is integer arithmetic
and an exact conversion: bit-equal to the plain draws. The analytic
normal's kernel (``csrc/normal.cu``) follows autograd's backward
operation for operation: bit-equal to autograd's first-order normal,
zeros' signs included, and frames through it to frames through
autograd's. The material gradient's kernel (``csrc/material_grad.cu``)
sums in another order than ``index_add_``'s atomics: within a stated
float32 bound of a float64 sum and of the plain backward, and the same
bits from run to run. K1c and K1d march
on a persistent lane pool (``csrc/march_pool.cuh``)
whose lane order follows atomics: their tests cover lane counts around one
grid's slots, a skewed state, repeat runs, scenes whose bunny is not last or
that hold two, and K1d's MLP on permuted points. These tests need a CUDA
device and skip without one; this file imports no jax, so it runs on a
machine that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch.config import HitCriterion, OmegaPolicy
from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.kernels import (fma_kernel, march_kernel,
                                             material_grad_kernel,
                                             normal_kernel, rng_kernel)
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.ops import camera as tcamera
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.ops import scene as scenelib
from raytracingpbr_tpu_torch.ops.scene import (_BUFFERS, ObjectSpec, Scene,
                                                bake, bucket_layout,
                                                make_scene)
from raytracingpbr_tpu_torch.ops.sdf import SHAPE, BunnyMLP, bunny_mlp_eval
from raytracingpbr_tpu_torch.utils import speedlight

from .torch_helpers import (NORMAL_POSES,  # noqa: F401
                            assert_normals_bit_equal, bunny_beside_shapes,
                            chained_resumes, cuda_device, many_objects_scene,
                            mixed_analytic_scene, normal_points,
                            normal_scene, random_rays)

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
    bound_before = dict(march_kernel.BOUND_LAUNCHES)
    k = tmarch.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=active, init=init))
    launched = 1 if o.shape[0] else 0
    assert march_kernel.LAUNCHES[kind] == before + launched
    # the escape-bound instance is counted apart as well
    bounded = launched if scenelib.escape_bound2(scene, cfg) is not None else 0
    assert march_kernel.BOUND_LAUNCHES == {
        v: n + (bounded if v == kind else 0) for v, n in bound_before.items()}
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


def _offset(scene):
    off = np.random.default_rng(5).normal(0, 0.05, (scene.num_objects, 3))
    return scene.replace(local_offset=torch.as_tensor(
        off.astype(np.float32), device=scene.device))


# scenes that fill many of K1a/K1b's object groups
GROUP_SCENES = {
    "mixed": mixed_analytic_scene,
    "mixed_offset": lambda dev: _offset(mixed_analytic_scene(dev)),
    "mixed_baked": lambda dev: bake(mixed_analytic_scene(dev)),
    "many_objects": many_objects_scene,
}


@pytest.mark.parametrize("case", sorted(GROUP_SCENES))
def test_grouped_scenes(cuda_device, case):
    """Every shape under permutations keyed by each axis and under
    matrices, twin boxes that tie across groups, 128 objects, a baked
    scene (every object on the matrix path), nonzero local offsets: fresh,
    gated and resumed, all-inactive, at a ragged N."""
    scene = GROUP_SCENES[case](cuda_device)
    cfg = cornell.full_config().replace(max_raymarch=64)
    assert march_kernel.variant(scene, cfg) == "k1a"
    o, d = _rays(4097, 6, (0.0, 0.0, 2.5), 0.4, cuda_device)
    _gated_resumed(scene, o, d, cfg, seed=6)
    k, _ = both(scene, o, d, cfg)
    assert bool(k.hit.any())


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("crit", sorted(march_kernel._CRIT, key=str))
@pytest.mark.parametrize("policy", sorted(march_kernel._POLICY, key=str))
def test_every_analytic_instance(cuda_device, policy, crit, bound):
    """Each (policy, criterion, bound) instance of K1a/K1b on the bounded
    mixed scene: fresh, gated and resumed, all-inactive."""
    scene = mixed_analytic_scene(cuda_device, plane=False)
    cfg = cornell.full_config().replace(
        omega_policy=policy, hit_criterion=crit, escape_bound=bound,
        omega=1.0 if policy == OmegaPolicy.CONSTANT else 1.6,
        max_raymarch=64)
    o, d = _rays(2049, 7, (0.0, 0.0, 2.5), 0.4, cuda_device)
    _gated_resumed(scene, o, d, cfg, seed=7)


@pytest.mark.parametrize("case", ["cornell", "mixed", "many_objects",
                                  "bunny_k1c", "bunny_k1d"])
def test_non_finite_rays(cuda_device, case):
    """Rays whose origin or direction has a NaN or an infinite coordinate,
    and rays whose origin or direction is finite but huge, beside ordinary
    rays: as in the plain march, only a sphere can be nearest to a
    non-finite point, where the fast path's fmaxf would drop a NaN and a
    permutation read one axis. K1a and K1b (``fold_non_finite``) on
    analytic scenes; K1c and K1d (``nearest_non_finite``, for lanes that
    fail ``bounded``) on the bunny beside every analytic shape, K1c
    bit-equal, K1d within the march bar and bit-equal on those rays, which
    reach no MLP."""
    bunny_case = case.startswith("bunny")
    if bunny_case:
        scene = bunny_beside_shapes(cuda_device)
        o, d = _aimed_rays(1024, 8, cuda_device)
    else:
        scene = {"cornell": cornell.full_scene,
                 "mixed": mixed_analytic_scene,
                 "many_objects": many_objects_scene}[case](cuda_device)
        o, d = _rays(1024, 8, (0.0, 0.0, 2.5), 0.4, cuda_device)
    bad = torch.tensor([float("nan"), float("inf"), -float("inf")],
                       device=cuda_device)
    k = torch.arange(0, 96, device=cuda_device)
    d[k, k % 3] = bad[k % 3]
    o[k + 96, k % 3] = bad[k % 3]
    # finite but huge: a point may overflow to infinity on the way
    big = torch.tensor([1e20, -3e37, 3.3e38], device=cuda_device)
    k = torch.arange(0, 32, device=cuda_device)
    o[k + 192, k % 3] = big[k % 3]
    d[k + 208, (k + 1) % 3] = big[k % 3]
    if bunny_case:
        cfgs = [bunny.glass_config(8).replace(bunny_mxu=case == "bunny_k1d")]
        cfgs.append(cfgs[0].replace(omega=1.6, omega_policy=(
            OmegaPolicy.ROLLBACK_TO_ONE), hit_criterion=HitCriterion.CONE))
    else:
        cfgs = [cornell.full_config(), demo.tokyo_config()]
    for cfg in cfgs:
        cfg = cfg.replace(max_raymarch=32)
        if bunny_case:
            assert march_kernel.variant(scene, cfg) == case[-3:]
        res, ref = both(scene, o, d, cfg)
        if case == "bunny_k1d":
            tmarch.assert_march_close(scene, o, d, res, ref, cfg)
            assert_bit_equal(*(tmarch.ResumableResult(*(v[:240] for v in r))
                               for r in (res, ref)))
        else:
            assert_bit_equal(res, ref)
        if bunny_case:
            # the sphere (object 0) was nearest to some non-finite points
            assert scene.shape_types[0] == SHAPE.SPHERE
            assert bool((ref.d[:192] == scene.scale[0, 0]).any())


def test_more_objects_than_staged_raise(cuda_device):
    scene = many_objects_scene(cuda_device, n=129)
    o, d = _rays(64, 0, (0.0, 0.0, 2.5), 0.4, cuda_device)
    with pytest.raises(NotImplementedError):
        march_kernel.march_resumable_cuda(scene, o, d, cornell.full_config())


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


# --- the persistent lane pool of K1c and K1d ---------------------------------


def _aimed_rays(n, seed, device):
    """Rays from around (0, 0, 2.5) aimed at the bunny with a spread."""
    o, _ = _rays(n, seed, (0.0, 0.0, 2.5), 0.1, device)
    d = -o + 0.35 * torch.randn(o.shape, generator=torch.Generator(
        device).manual_seed(seed), device=device)
    return o, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _check(scene, o, d, cfg, active=None, init=None):
    """The kernel against the plain march: K1c bit-equal, K1d within the
    march bar."""
    k, p = both(scene, o, d, cfg, active=active, init=init)
    if cfg.bunny_mxu:
        tmarch.assert_march_close(scene, o, d, k, p, cfg)
    else:
        assert_bit_equal(k, p)
    return k


def _grid_slots(kind):
    per_sm, sms = march_kernel.pool_occupancy(kind)
    assert per_sm >= 1 and sms >= 1
    return per_sm * sms * march_kernel.POOL_SLOTS


@pytest.mark.parametrize("n", [1, 31, 257, "slots-3", "slots+5", 4097])
@pytest.mark.parametrize("kind", ["k1c", "k1d"])
def test_pool_lane_counts(cuda_device, kind, n):
    """Lane counts under, at and over one persistent grid's slots: fresh,
    gated and resumed calls."""
    if isinstance(n, str):
        n = _grid_slots(kind) + int(n[5:])
    scene = bunny.glass_scene(cuda_device)
    cfg = bunny.glass_config(8).replace(max_raymarch=32,
                                        bunny_mxu=kind == "k1d")
    o, d = _rays(n, n % 1000, (0.0, 0.0, 2.0), 0.5, cuda_device)
    k = _check(scene, o, d, cfg)
    rng = np.random.default_rng(n)
    active = torch.as_tensor(rng.random(n) < 0.5, device=cuda_device)
    _check(scene, o, d, cfg, active=active, init=(k.t, k.w, k.s, k.d))


def _skewed(scene, o, d, cfg):
    """Half the lanes gated; a quarter resumed from where a first call hit
    (one more trip); a quarter fresh with omega 0.01 (the whole budget).
    Lanes of the kinds interleave, so every warp of 32 holds all four."""
    n = o.shape[0]
    k0 = tmarch.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg))
    g = torch.arange(n, device=o.device) % 4
    one, slow = (g == 2) & k0.hit, g == 3
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=o.device)
    init = (torch.where(one, k0.t, full(cfg.march_t0)),
            torch.where(one, k0.w, torch.where(slow, full(0.01),
                                               full(cfg.omega))),
            torch.where(one, k0.s, full(0.0)),
            torch.where(one, k0.d, full(1e3)))
    return one | slow, init, one, slow


@pytest.mark.parametrize("kind", ["k1c", "k1d"])
def test_pool_skewed_state_repeatable(cuda_device, kind):
    """On a skewed state the pool's warps march fewer lane slots than warps
    that keep their lanes, and run fewer MLP evaluations, at least one per
    needed (lane, trip); two runs on the same inputs are bit-identical."""
    scene = bunny.glass_scene(cuda_device)
    cfg = bunny.glass_config(8).replace(max_raymarch=32,
                                        bunny_mxu=kind == "k1d")
    o, d = _aimed_rays(16 * _grid_slots(kind), 11, cuda_device)
    active, init, one, slow = _skewed(scene, o, d, cfg)
    k = _check(scene, o, d, cfg, active=active, init=init)
    assert float((k.fin[one] == 1).float().mean()) > 0.9
    assert float((k.fin[slow] == 32).float().mean()) > 0.9
    assert int(k.fin[~active].sum()) == 0
    again = march_kernel.march_resumable_cuda(scene, o, d, cfg,
                                              active=active, init=init)
    assert_bit_equal(k, again)
    executed, mlp = speedlight.executed_counts(scene, o, d, cfg, active,
                                               init)
    needed = int(k.fin.sum())
    assert needed <= executed
    assert 4 * executed < 3 * speedlight.warp_executed(k.fin)
    support, warp_support = speedlight.support_lane_trips(scene, o, d, cfg,
                                                          active, init)
    assert support <= mlp < warp_support
    speedlight.mlp_work(support, mlp)


def reordered(scene, order):
    """The scene with its objects in ``order``: ``make_scene`` sorts by
    shape type, which puts the bunnies last."""
    types = tuple(scene.shape_types[i] for i in order)
    splits, buckets = bucket_layout(types)
    idx = torch.tensor(order, device=scene.device)
    return Scene(types, splits, buckets, scene.box_round,
                 tuple(scene.rot_perm[i] for i in order), bunny=scene.bunny,
                 **{k: getattr(scene, k)[idx] for k in _BUFFERS})


def _bunny_spec(pos, rot=(-90, 0, 0)):
    return ObjectSpec(SHAPE.BUNNY, pos, rot, (1, 1, 1))


POOL_SCENES = {
    # bunny, sphere, box: the bunny first
    "bunny_first": ([_bunny_spec((0, 0, 0)),
                     ObjectSpec(SHAPE.SPHERE, (0.9, 0.2, 0.0), (0, 0, 0),
                                (0.3,) * 3),
                     ObjectSpec(SHAPE.BOX, (-0.9, -0.3, 0.2), (10, 30, 0),
                                (0.25, 0.2, 0.3))], [2, 0, 1]),
    # bunny, sphere, bunny, plane: two bunnies whose unit spheres overlap
    "two_bunnies": ([_bunny_spec((-0.55, 0.0, 0.0)),
                     _bunny_spec((0.6, 0.1, -0.2), (-90, 40, 0)),
                     ObjectSpec(SHAPE.SPHERE, (0.0, 0.8, 0.0), (0, 0, 0),
                                (0.25,) * 3),
                     ObjectSpec(SHAPE.PLANE, (0, -1.0, 0), (0, 0, 0),
                                (1, 0.0, 1))], [2, 0, 3, 1]),
}


@pytest.mark.parametrize("case", sorted(POOL_SCENES))
@pytest.mark.parametrize("kind", ["k1c", "k1d"])
def test_pool_object_order(cuda_device, kind, case):
    """The fold of the MLP results keeps the object order: a bunny before
    the analytic objects, and two bunnies, against the plain march."""
    specs, order = POOL_SCENES[case]
    scene = reordered(make_scene(specs, device=cuda_device), order)
    assert scene.shape_types[0] == SHAPE.BUNNY
    cfg = bunny.glass_config(8).replace(max_raymarch=64,
                                        bunny_mxu=kind == "k1d")
    assert march_kernel.variant(scene, cfg) == kind
    o, d = _aimed_rays(8192, 5, cuda_device)
    k = _check(scene, o, d, cfg)
    hit = k.index[k.hit.bool()]
    bunnies = [i for i, t in enumerate(scene.shape_types)
               if t == SHAPE.BUNNY]
    assert all(bool((hit == i).any()) for i in bunnies)
    _check(scene, o, d, cfg.replace(escape_bound=True))


def test_k1d_mlp_permuted_points_bit_for_bit(cuda_device):
    """A point's value does not depend on its warp neighbours: the MLP of a
    permuted point set is the permuted MLP, bit for bit."""
    scene = bunny.glass_scene(cuda_device)
    p = unit_ball(4097, 7, cuda_device)
    got = march_kernel.bunny_mlp_mxu(scene, p)
    perm = torch.randperm(p.shape[0], generator=torch.Generator().manual_seed(
        7)).to(cuda_device)
    assert torch.equal(march_kernel.bunny_mlp_mxu(scene, p[perm]), got[perm])
    # and beside zero rows, as the last warp of a queue pads them
    padded = torch.cat([p[:5], torch.zeros((27, 3), device=cuda_device)])
    assert torch.equal(march_kernel.bunny_mlp_mxu(scene, padded)[:5],
                       got[:5])


# --- the gradient paths on the card -----------------------------------------


def _grads(scene, env, cam, cfg, mode, fields=("albedo", "emission")):
    """The mean image's gradients in ``fields`` through ``render_pixels``
    (spp 1), and the march launches that took."""
    from raytracingpbr_tpu_torch.parallel import train as ptrain
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in fields}
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                       device=scene.device)
    march_kernel.reset_launches()
    img = ptrain.render_pixels(scene.replace(**leaves), env, cam, pid, cfg,
                               spp=1, differentiable=mode)
    grads = torch.autograd.grad(img.mean(), list(leaves.values()))
    return grads, dict(march_kernel.LAUNCHES), dict(
        march_kernel.BOUND_LAUNCHES)


def test_gradient_paths_march_through_the_kernels(cuda_device):
    """Scan-AD and path replay handed CUDA tensors march through K1a (one
    launch a bounce; replay's backward re-marches without the checkpoint)
    and no other kernel, and replay equals scan-AD on the card at
    ``tests/test_replay.py``'s bar (rtol 2e-4, atol 2e-6 max)."""
    scene, env, cam = (cornell.full_scene(cuda_device),
                       cornell.sky(cuda_device),
                       cornell.full_camera(cuda_device))
    cfg = cornell.full_config().replace(resolution=(32, 32), max_raytrace=6)
    scan, l_scan, _ = _grads(scene, env, cam, cfg, True)
    rep, l_rep, _ = _grads(scene, env, cam, cfg, "replay")
    off, l_off, _ = _grads(scene, env, cam,
                           cfg.replace(replay_march_checkpoint=False),
                           "replay")
    for launches in (l_scan, l_rep, l_off):
        assert launches["k1a"] > 0
        assert not any(v for k, v in launches.items() if k != "k1a")
    # the backward without the checkpoint marches every bounce again
    assert l_off["k1a"] == 2 * l_rep["k1a"]
    for a, b, c in zip(scan, rep, off):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(b, a, rtol=2e-4,
                                   atol=2e-6 * float(a.abs().max()))
        torch.testing.assert_close(c, b, rtol=1e-5,
                                   atol=1e-7 * float(b.abs().max()))


def test_replay_nee_shadow_rays_through_k1b(cuda_device):
    """Replay with NEE on the card: the bounces through K1a, the shadow
    rays through K1b's escape-bound instance."""
    from raytracingpbr_tpu_torch.ops import ibl
    img = np.full((64, 32, 3), 0.05, np.float32)
    img[40:44, 24:28] = 25.0
    env = ibl.with_env_sampler(ibl.hdr_environment(img, prebake=False,
                                                   device=cuda_device))
    scene, cam = (cornell.full_scene(cuda_device),
                  cornell.full_camera(cuda_device))
    cfg = cornell.full_config().replace(resolution=(32, 32), max_raytrace=8,
                                        env_sampling=True)
    (g_alb, _), launches, bound = _grads(scene, env, cam, cfg, "replay")
    assert launches["k1a"] > 0 and launches["k1b"] > 0
    assert bound["k1b"] == launches["k1b"] and bound["k1a"] == 0
    assert bool(torch.isfinite(g_alb).all())
    assert float(g_alb.abs().max()) > 0


def test_float64_refused_on_the_card(cuda_device):
    """The kernels are f32: a float64 ray or scene on the card raises,
    and is never cast."""
    scene = cornell.full_scene(cuda_device)
    o, d = primaries(cornell.full_config().replace(resolution=(8, 8)),
                     cuda_device)
    with pytest.raises(ValueError, match="float32"):
        march_kernel.march_resumable_cuda(scene, o.double(), d.double(),
                                          cornell.full_config())
    scene64 = scene.replace(**{k: getattr(scene, k).double()
                               for k in _BUFFERS})
    with pytest.raises(ValueError, match="float32"):
        march_kernel.march_resumable_cuda(scene64, o, d,
                                          cornell.full_config())


def test_train_step_matrix_then_kernel_equals_plain(cuda_device):
    """A train step that moves the matrix on the card drops the
    permutation records, and K1a on the updated scene is bit-equal to the
    plain march (the kernel reads no stale permutation)."""
    from raytracingpbr_tpu_torch.ops import ibl
    from raytracingpbr_tpu_torch.parallel import train as ptrain
    scene, cam = (cornell.full_scene(cuda_device),
                  cornell.full_camera(cuda_device))
    cfg = cornell.full_config().replace(resolution=(16, 16), max_raytrace=3)
    step = ptrain.make_sharded_train_step(
        ibl.gradient_sky(device=cuda_device), cam, cfg,
        param_filter=ptrain.param_mask({"matrix"}))
    ts = ptrain.make_train_state(scene, ptrain.adam(0.05))
    ts, loss = step(ts, torch.zeros((cfg.num_pixels, 3),
                                    device=cuda_device))
    assert bool(torch.isfinite(loss))
    assert not torch.equal(ts.scene.matrix, scene.matrix)
    assert all(p is None for p in ts.scene.rot_perm)
    o, d = primaries(cornell.full_config(), cuda_device)
    assert_bit_equal(*both(ts.scene, o, d, cornell.full_config()))


def _recorded(fn):
    """Runs ``fn()`` with every march kernel call recorded as it was made:
    the scene's float buffers as they stood (cloned after the launch, on
    its stream), the inputs and the kernel's outputs: ``[(scene, origin,
    direction, active, init, cfg, outputs)]``."""
    real = march_kernel.march_resumable_cuda
    calls = []
    copy = lambda v: None if v is None else v.clone()

    def record(sc, o, d, c, active=None, init=None, **k):
        out = real(sc, o, d, c, active=active, init=init, **k)
        snap = scenelib.with_params(sc, [v.detach().clone()
                                         for v in scenelib.params(sc)])
        calls.append((snap, o.clone(), d.clone(), copy(active),
                      None if init is None else tuple(map(copy, init)), c,
                      tuple(map(copy, out))))
        return out
    march_kernel.march_resumable_cuda = record
    try:
        out = fn()
    finally:
        march_kernel.march_resumable_cuda = real
    return out, calls


def _hold(calls):
    """Each recorded call's outputs against the plain march on its
    recorded inputs and scene: K1c bit-equal, K1d within the march
    bar."""
    for sc, o, d, a, i, c, out in calls:
        k = tmarch.ResumableResult(*out)
        p = tmarch.march_resumable_plain(sc, o, d, c, active=a, init=i)
        if march_kernel.variant(sc, c) == "k1d":
            tmarch.assert_march_close(sc, o, d, k, p, c)
        else:
            assert_bit_equal(k, p)


BUNNY_GRAD_FIELDS = tuple("bunny_" + k for k in BunnyMLP._fields) + (
    "matrix", "albedo")


@pytest.mark.parametrize("mxu", [False, True], ids=["k1c", "k1d"])
def test_bunny_scan_ad_step_through_k1c_and_k1d(cuda_device, mxu):
    """A scan-AD step on the glass bunny at 16x16, 8 bounces, spp 1, the
    MSE against zeros, with every MLP tensor, the matrix and the albedo
    requiring grad: the march launches K1c (K1d under ``bunny_mxu``) and
    no other kernel, a launch a bounce; every gradient is finite and
    nonzero; every march call of the step, as it was made, is bit-equal
    to the plain march on its recorded inputs (K1c) or within the march
    bar (K1d)."""
    from raytracingpbr_tpu_torch.parallel import train as ptrain
    scene = bunny.glass_scene(cuda_device)
    env = bunny.glass_environment(device=cuda_device)
    cam = bunny.camera(1.0, cuda_device)
    cfg = bunny.glass_config().replace(resolution=(16, 16), max_raytrace=8,
                                       bunny_mxu=mxu)
    names = scenelib.param_names(scene)
    leaves = [v.clone().requires_grad_(k in BUNNY_GRAD_FIELDS)
              for k, v in zip(names, scenelib.params(scene))]
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                       device=cuda_device)
    march_kernel.reset_launches()

    def step():
        img = ptrain.render_pixels(scenelib.with_params(scene, leaves), env,
                                   cam, pid, cfg, spp=1)
        return torch.autograd.grad(torch.mean(img ** 2),
                                   [v for v in leaves if v.requires_grad])
    grads, calls = _recorded(step)
    kind = "k1d" if mxu else "k1c"
    launches = dict(march_kernel.LAUNCHES)
    assert 0 < launches[kind] <= cfg.max_raytrace
    assert not any(v for k, v in launches.items() if k != kind)
    assert len(calls) == launches[kind]
    for g in grads:
        assert bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0
    _hold(calls)


def test_bunny_train_step_then_kernel_marches_the_update(cuda_device):
    """A train step with ``param_mask(set())`` on the glass bunny (16x16,
    8 bounces) freezes every object buffer and moves the MLP in place;
    the march calls of the next step, as they were made, are bit-equal to
    the plain march on the scene as it stood at each call (the kernel's
    pack follows the tensors' version counters), and K1c on the updated
    scene is not K1c on the old one."""
    from raytracingpbr_tpu_torch.parallel import train as ptrain
    scene = bunny.glass_scene(cuda_device)
    env = bunny.glass_environment(device=cuda_device)
    cam = bunny.camera(1.0, cuda_device)
    cfg = bunny.glass_config().replace(resolution=(16, 16), max_raytrace=8)
    target = ptrain.render_pixels(
        scene, env, cam, torch.arange(cfg.num_pixels, device=cuda_device),
        cfg, spp=1, sample_offset=10_000, differentiable=False)
    start = scene.replace(bunny=scene.bunny._replace(
        bias_out=scene.bunny.bias_out + 0.01))
    step = ptrain.make_sharded_train_step(
        env, cam, cfg, param_filter=ptrain.param_mask(set()))
    ts = ptrain.make_train_state(start, ptrain.adam(1e-3))
    before = [v.clone() for v in scenelib.params(ts.scene)]
    ts, loss = step(ts, target)
    assert bool(torch.isfinite(loss))
    for k, a, b in zip(scenelib.param_names(ts.scene), before,
                       scenelib.params(ts.scene)):
        assert torch.equal(a, b) == (k in _BUFFERS), k
    (ts, loss), calls = _recorded(lambda: step(ts, target))
    assert calls and bool(torch.isfinite(loss))
    _hold(calls)
    o, d = calls[0][1], calls[0][2]  # the next step's primaries
    new = march_kernel.march_resumable_cuda(ts.scene, o, d, cfg)
    old = march_kernel.march_resumable_cuda(start, o, d, cfg)
    assert not torch.equal(new[0], old[0])


CHAIN_CASES = {
    "k1a": lambda dev: (cornell.full_scene(dev),
                        cornell.full_config().replace(max_raymarch=256)),
    "k1b": lambda dev: (demo.engine_scene(dev),
                        demo.engine_config().replace(max_raymarch=256)),
    "k1c": lambda dev: (bunny.glass_scene(dev),
                        bunny.glass_config().replace(max_raymarch=256)),
    "k1d": lambda dev: (bunny.glass_scene(dev), bunny.glass_config().replace(
        max_raymarch=256, bunny_mxu=True)),
}
# the doubling schedule of 256 trips
CHAIN_BUDGETS = (32, 32, 64, 128)


@pytest.mark.parametrize("kind", sorted(CHAIN_CASES))
def test_chained_resumes_equal_single_call(cuda_device, kind):
    """Chained resumes through each kernel over the doubling schedule, the
    lanes done or gated off at entry sitting out the later calls: one
    launch a call, no other, and the eight outputs (``fin`` summed) equal
    one launch of the whole budget bit for bit, gated lanes included (K1d
    too: its MLP rows are independent); ``march()`` with
    ``cfg.march_compaction`` gives that call's results."""
    scene, cfg = CHAIN_CASES[kind](cuda_device)
    assert sum(CHAIN_BUDGETS) == cfg.max_raymarch
    o, d = (torch.as_tensor(v, device=cuda_device)
            for v in random_rays(5000, 3, center=(0.0, 0.0, 3.0),
                                 spread=0.3))
    act = torch.as_tensor(np.random.default_rng(1).random(5000) < 0.8,
                          device=cuda_device)
    single = tmarch.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=act))
    march_kernel.reset_launches()
    out = chained_resumes(scene, o, d, cfg, CHAIN_BUDGETS, act)
    torch.cuda.synchronize()
    assert march_kernel.LAUNCHES[kind] == len(CHAIN_BUDGETS)
    assert sum(march_kernel.LAUNCHES.values()) == march_kernel.LAUNCHES[kind]
    assert int((single.fin > CHAIN_BUDGETS[0]).sum()) > 0
    assert_bit_equal(out, single)
    res = tmarch.march(scene, o, d, cfg.replace(march_compaction=True),
                       differentiable=False, active=act)
    assert torch.equal(res.t, single.t) and torch.equal(res.hit, single.hit)


def test_pixel_uv_on_the_card_is_the_cpus(cuda_device):
    """The Cornell 480x480 primaries (``bench.py``'s utilization rays):
    ``pixel_uv``'s film coordinates on the card bit-equal to the CPU's
    (its divisors are tensors on the device: the card's division by a
    host scalar is a multiply by its reciprocal). The rays ``get_ray``
    makes from them within 1e-6: the card's ``tan`` of the camera's half
    angle, its thin-lens ``sqrt``/``sin``/``cos`` and its ``vector_norm``
    round apart from the CPU's, and making them agree through float64
    would change the CPU's bits (``tools/ab_get_ray.py`` prints, op by
    op, the share of lanes bit-equal and the share float64 would keep)."""
    cfg = cornell.full_config()

    def film_and_rays(dev):
        pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
        u = trng.uniform4(pid, 0, 1, cfg.seed)
        uv = tcamera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
        o, d = primaries(cfg, dev)
        return uv, o, d
    (uv, o, d), (uv_c, o_c, d_c) = (film_and_rays(cuda_device),
                                    film_and_rays(torch.device("cpu")))
    same = (uv.cpu() == uv_c).all(dim=-1)
    assert bool(same.all()), float(same.double().mean())
    torch.testing.assert_close(o.cpu(), o_c, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(d.cpu(), d_c, rtol=1e-6, atol=1e-6)


def test_reproject_on_the_card_against_the_cpu(cuda_device):
    """``reproject`` on the card against the CPU on the same state: the
    accumulator within rtol 1e-5 on at least 99.9% of the pixels (the
    card's atomic adds reorder a pixel's sums); the depths bit-equal (an
    ``amin`` scatter, exact in any order, of distances that
    ``pixel_center_rays`` and the warp compute alike on both devices:
    divisors on the device, squares summed in order, roots from
    float64)."""
    import dataclasses

    from raytracingpbr_tpu_torch.core.types import (make_camera,
                                                    make_frame_state)
    from raytracingpbr_tpu_torch.ops import reproject as rp
    from raytracingpbr_tpu_torch.ops.integrator import render_frame

    cfg = cornell.minimal_config().replace(resolution=(64, 48),
                                           max_raytrace=8)
    scene, env = cornell.minimal_scene(cuda_device), cornell.sky(cuda_device)
    cam = cornell.minimal_camera(cuda_device)
    state = make_frame_state(cfg.num_pixels, cuda_device)
    for _ in range(4):
        _, state = render_frame(scene, env, cam, state, cfg)
    moved = make_camera(lookfrom=(0.03, 0.0, 3.4), lookat=(0.0, 0.0, -1.0),
                        vfov=40.0, aspect=cfg.width / cfg.height,
                        device=cuda_device)

    def cpu(x):
        return type(x)(**{k: cpu(v) if dataclasses.is_dataclass(v)
                          else v.cpu() for k, v in vars(x).items()})
    got = rp.reproject(state, cam, moved, cfg)
    ref = rp.reproject(cpu(state), cpu(cam), cpu(moved), cfg)
    ok = torch.isclose(got.accum.cpu(), ref.accum, rtol=1e-5, atol=1e-6)
    assert float(ok.all(dim=1).float().mean()) >= 0.999
    assert torch.equal(got.hit_t.cpu(), ref.hit_t), float(
        (got.hit_t.cpu() == ref.hit_t).float().mean())


# --- the sharded paths (parallel/) -------------------------------------------

def _sharded_setup(device, res=(64, 64)):
    cfg = cornell.full_config().replace(resolution=res, max_raytrace=16)
    return (cornell.full_scene(device), cornell.sky(device),
            cornell.full_camera(device), cfg)


@pytest.mark.parametrize("tiles,samples,layout", [
    (8, 1, "contiguous"), (8, 1, "strided"), (4, 2, "contiguous"),
    (2, 4, "contiguous")])
def test_sharded_still_on_the_card(cuda_device, tiles, samples, layout):
    """``render_image_sharded`` through K1a: a tiles-only mesh gives
    ``render_image``'s bits under both layouts, a sample mesh is within
    atol 1e-5 / rtol 1e-4; K1a launches, no other march kernel."""
    from raytracingpbr_tpu_torch.ops.integrator import render_image
    from raytracingpbr_tpu_torch.parallel import mesh as meshlib
    from raytracingpbr_tpu_torch.parallel import render as prender
    scene, env, cam, cfg = _sharded_setup(cuda_device)
    single = render_image(scene, env, cam, cfg, spp=4, tonemapped=False)
    march_kernel.reset_launches()
    got = prender.render_image_sharded(
        scene, env, cam, cfg, meshlib.make_mesh(tiles, samples), spp=4,
        tonemapped=False, layout=layout)
    torch.cuda.synchronize()
    assert march_kernel.LAUNCHES["k1a"] > 0
    assert sum(march_kernel.LAUNCHES.values()) == march_kernel.LAUNCHES["k1a"]
    if samples == 1:
        assert torch.equal(got, single)
    torch.testing.assert_close(got, single, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_sharded_frames_on_the_card(cuda_device, layout):
    """Four frames on the (8, 1) mesh, then eight with the adaptive gate:
    pixels and accumulator ``render_frame``'s bit for bit, and the same
    pixels stopped."""
    from raytracingpbr_tpu_torch.core.types import make_frame_state
    from raytracingpbr_tpu_torch.ops.integrator import render_frame
    from raytracingpbr_tpu_torch.parallel import mesh as meshlib
    from raytracingpbr_tpu_torch.parallel import render as prender
    scene, env, cam, cfg = _sharded_setup(cuda_device)
    mesh = meshlib.make_mesh(8, 1)
    for c, count in ((cfg, 4), (cfg.replace(adaptive_sampling=True,
                                            noise_threshold=0.15), 8)):
        st = make_frame_state(c.num_pixels, cuda_device)
        sm = prender.shard_frame_state(st, mesh, layout)
        for _ in range(count):
            px, st = render_frame(scene, env, cam, st, c)
            pm, sm = prender.render_frame_sharded(scene, env, cam, sm, c,
                                                  mesh, layout=layout)
        un = lambda x: prender.unshard_pixels(x, 8, layout)
        assert torch.equal(un(pm), px)
        assert torch.equal(un(sm.accum), st.accum)
        if c.adaptive_sampling:
            stopped = st.noise <= c.noise_threshold
            assert bool(stopped.any())
            assert torch.equal(un(sm.noise) <= c.noise_threshold, stopped)


def test_sharded_reprojection_on_the_card(cuda_device):
    """Three strided frames with ``cfg.reprojection``, a move and a
    reprojected refresh: the accumulator within rtol 1e-5 of
    ``render_frame(prev_cam=...)``'s on at least 99.9% of pixels (the
    warp's atomic adds reorder a pixel's sums)."""
    import dataclasses

    from raytracingpbr_tpu_torch.core.types import make_frame_state
    from raytracingpbr_tpu_torch.ops.integrator import render_frame
    from raytracingpbr_tpu_torch.parallel import mesh as meshlib
    from raytracingpbr_tpu_torch.parallel import render as prender
    scene, env, cam, cfg = _sharded_setup(cuda_device)
    cfg = cfg.replace(reprojection=True)
    moved = dataclasses.replace(cam, lookfrom=cam.lookfrom + torch.tensor(
        [0.08, 0.0, 0.0], device=cuda_device))
    mesh = meshlib.make_mesh(8, 1)
    st = make_frame_state(cfg.num_pixels, cuda_device)
    sm = prender.shard_frame_state(st, mesh, "strided")
    for _ in range(3):
        _, st = render_frame(scene, env, cam, st, cfg)
        _, sm = prender.render_frame_sharded(scene, env, cam, sm, cfg, mesh,
                                             layout="strided")
    _, st = render_frame(scene, env, moved, st, cfg, refreshing=True,
                         prev_cam=cam)
    _, sm = prender.render_frame_sharded(scene, env, moved, sm, cfg, mesh,
                                         refreshing=True, prev_cam=cam,
                                         layout="strided")
    acc = prender.unshard_pixels(sm.accum, 8, "strided")
    ok = torch.isclose(acc, st.accum, rtol=1e-5, atol=1e-6).all(dim=1)
    assert float(ok.float().mean()) >= 0.999


def test_two_processes_share_the_card():
    """``apps.multihost`` on the card over gloo (two processes on one
    card; the gathered tensors staged through host memory): the still
    bit-identical to one process, two train steps within rtol 1e-5."""
    import os
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "raytracingpbr_tpu_torch.apps.multihost",
         "--backend", "gloo", "--resolution", "64", "--train-steps", "2",
         "--frames", "2"], cwd=repo, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIHOST OK" in proc.stdout


def test_nccl_world_of_one(cuda_device, tmp_path):
    """A one-process NCCL group: the still and a train step through its
    collectives (called, not skipped) equal the group-less mesh's."""
    import torch.distributed as dist

    from raytracingpbr_tpu_torch.parallel import mesh as meshlib
    from raytracingpbr_tpu_torch.parallel import render as prender
    from raytracingpbr_tpu_torch.parallel import train as ptrain
    scene, env, cam, cfg = _sharded_setup(cuda_device, (32, 32))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        out = {}
        for group in (None, dist.group.WORLD):
            mesh = meshlib.make_mesh(8, 1, group=group)
            img = prender.render_image_sharded(scene, env, cam, cfg, mesh,
                                               spp=2)
            step = ptrain.make_sharded_train_step(
                env, cam, cfg.replace(max_raytrace=4),
                meshlib.make_mesh(4, 2, group=group),
                param_filter=ptrain.albedo_only_filter)
            ts = ptrain.make_train_state(scene, ptrain.adam(0.02))
            ts, loss = step(ts, torch.zeros((cfg.num_pixels, 3),
                                            device=cuda_device))
            out[group is None] = (img, loss, ts.scene.albedo)
        assert dist.get_backend() == "nccl"
        assert torch.equal(out[True][0], out[False][0])
        torch.testing.assert_close(out[True][1], out[False][1], rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(out[True][2], out[False][2], rtol=1e-5,
                                   atol=0)
    finally:
        dist.destroy_process_group()


# --- the counter RNG kernel (csrc/rng.cu) ------------------------------------

RNG_DRAWS = {"uniform4": (trng.uniform4, trng.uniform4_plain, 4),
             "uniform": (trng.uniform, trng.uniform_plain, 1),
             "r2_uniform4": (trng.r2_uniform4, trng.r2_uniform4_plain, 4)}
RNG_INT_STEPS = {"0": 0, "7": 7, "2**31+5": 2**31 + 5, "2**32-1": 2**32 - 1}
RNG_STEPS = (*RNG_INT_STEPS, "0-dim card", "lane int32", "lane int64")


def _rng_ids(n, dtype, device):
    """Ids over the whole 32-bit range and past it: int64 ids from -2**33
    to 2**33 (2**31 and above among them), int32 ids their low 32 bits
    (negative where the word is 2**31 or above)."""
    v = np.random.default_rng(n).integers(-2**33, 2**33, n, dtype=np.int64)
    v[:4] = [0, 2**31, 2**32 - 1, -1][:n]
    if dtype == torch.int32:
        v = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return torch.from_numpy(v).to(device)


def _rng_step(form, n, device):
    rng = np.random.default_rng(n + 1)
    if form == "0-dim card":
        return torch.tensor(-2**32 - 5, device=device)
    if form == "lane int32":
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, n, dtype=np.int64).astype(np.int32)).to(device)
    if form == "lane int64":
        return torch.from_numpy(rng.integers(
            -2**40, 2**40, n, dtype=np.int64)).to(device)
    return RNG_INT_STEPS[form]


@pytest.mark.parametrize("n", [1, 255, 257, 2_073_600])
@pytest.mark.parametrize("form", RNG_STEPS)
@pytest.mark.parametrize("name", sorted(RNG_DRAWS))
def test_rng_kernel_bit_equal_to_the_plain_draws(cuda_device, name, form,
                                                 n):
    """Every draw of the kernel bit-equal to the plain draw on the card:
    int32 and int64 ids, each form of ``step``, two (stream, seed) pairs,
    float32 and float64, one launch a draw."""
    draw, plain, rows = RNG_DRAWS[name]
    step = _rng_step(form, n, cuda_device)
    mode = "r2_uniform4" if name == "r2_uniform4" else "uniform4"
    for pid_dtype in (torch.int32, torch.int64):
        pid = _rng_ids(n, pid_dtype, cuda_device)
        for stream, seed in ((0, 0), (2, 1234567)):
            for dtype in (torch.float32, torch.float64):
                before = dict(rng_kernel.LAUNCHES)
                got = draw(pid, step, stream, seed, dtype)
                assert rng_kernel.LAUNCHES == before | {
                    mode: before[mode] + 1}
                ref = plain(pid, step, stream, seed, dtype)
                got = (got,) if rows == 1 else got
                ref = (ref,) if rows == 1 else ref
                assert len(got) == len(ref) == rows
                for g, r in zip(got, ref):
                    assert g.dtype == dtype and g.shape == pid.shape
                    assert torch.equal(g, r), (
                        f"{int((g != r).sum())} of {n} lanes differ")


def test_rng_kernel_draws_without_a_host_sync(cuda_device):
    """The draws with a step held on the card (the frame counter) or one a
    lane run under ``set_sync_debug_mode("error")``, each one launch; each
    output is an allocation of its own of one row's bytes, as the plain
    draw's are."""
    pid = torch.arange(1 << 16, dtype=torch.int64, device=cuda_device)
    steps = (torch.tensor(12, device=cuda_device), pid.to(torch.int32) * 3)
    trng.uniform4(pid, steps[0], 1)
    torch.cuda.synchronize()
    rng_kernel.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in steps:
            u4 = trng.uniform4(pid, step, 1, 5)
            u = trng.uniform(pid, step, 0, 5)
            r2 = trng.r2_uniform4(pid, step, 1, 5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rng_kernel.LAUNCHES == {"uniform4": 4, "r2_uniform4": 2}
    assert len(u4) == len(r2) == 4
    for out in (u4, r2, (u,)):
        assert len({o.untyped_storage().data_ptr() for o in out}) == len(out)
        assert all(o.untyped_storage().nbytes() == pid.shape[0] * 4
                   for o in out)


# --- the analytic normal kernel (csrc/normal.cu) -----------------------------

NORMAL_SCENES = {"cornell": cornell.full_scene, "tokyo": demo.scene_demo_scene,
                 "engine": demo.engine_scene, "mixed": mixed_analytic_scene}


def _normal_both(scene, idx, p):
    """The kernel through ``calc_normal`` (one launch, the kernel route)
    and autograd's first-order normal on the same lanes."""
    before = dict(normal_kernel.LAUNCHES)
    routes = dict(scenelib.NORMAL_ROUTES)
    got = scenelib.calc_normal(scene, idx, p)
    assert normal_kernel.LAUNCHES == {"normal": before["normal"] + 1}
    assert scenelib.NORMAL_ROUTES == routes | {"kernel": routes["kernel"] + 1}
    return got, scenelib.calc_normal_autograd(scene, idx, p)


@pytest.mark.parametrize("box_round", [0.03, 0.0], ids=["round", "sharp"])
@pytest.mark.parametrize("pose", sorted(NORMAL_POSES))
def test_normal_kernel_bit_equal_to_autograd(cuda_device, pose, box_round):
    """Every analytic shape in every pose, rounded and sharp boxes, at
    about 1 M lanes: the lattice of faces, edges, corners, rims, axes and
    centres, random points, missed lanes at far points and NaN points,
    int32 and int64 indices: bit for bit, zeros' signs too."""
    scene = normal_scene(pose, box_round, cuda_device)
    idx, p = normal_points(scene, 1 << 20, seed=len(pose))
    idx, p = idx.to(cuda_device), p.to(cuda_device)
    for ids in (idx, idx.to(torch.int64)):
        assert_normals_bit_equal(*_normal_both(scene, ids, p))


@pytest.mark.parametrize("name", sorted(NORMAL_SCENES))
def test_normal_kernel_on_hit_points(cuda_device, name):
    """The model scenes' primary hits through the march (missed lanes
    included, object 0 at a far point) and points about their objects,
    on a strided ``p`` of two batch axes."""
    scene = NORMAL_SCENES[name](cuda_device)
    cfg = cornell.full_config().replace(resolution=(256, 256))
    o, d = primaries(cfg, cuda_device)
    if name != "cornell":
        o = o + torch.tensor([0.0, -0.2, 4.5], device=cuda_device)
    res = tmarch.march(scene, o, d, cfg.replace(max_raymarch=256))
    assert_normals_bit_equal(*_normal_both(scene, res.index, res.position))
    idx, p = normal_points(scene, 1 << 18, seed=11)
    n = idx.shape[0] // 2 * 2
    pw = torch.zeros((n, 4), device=cuda_device)
    pw[:, :3] = p[:n].to(cuda_device)
    ps = pw[:, :3].reshape(2, -1, 3)  # not contiguous
    assert_normals_bit_equal(*_normal_both(
        scene, idx[:n].to(cuda_device).reshape(2, -1), ps))


def test_normal_kernel_without_a_host_sync(cuda_device):
    """``calc_normal`` on the kernel route runs under
    ``set_sync_debug_mode("error")`` on an animated scene (``animate``'s
    offset a broadcast view read in place), one launch a call."""
    scene = scenelib.animate(normal_scene("general", 0.03, cuda_device),
                             torch.tensor(12, device=cuda_device))
    idx, p = normal_points(scene, 1 << 16, seed=2)
    idx, p = idx.to(cuda_device), p.to(cuda_device)
    scenelib.calc_normal(scene, idx, p)
    torch.cuda.synchronize()
    normal_kernel.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [scenelib.calc_normal(scene, idx, p) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert normal_kernel.LAUNCHES == {"normal": 3}
    want = scenelib.calc_normal_autograd(scene, idx, p)
    for got in outs:
        assert_normals_bit_equal(got, want)


def _frames_state(scene, env, cam, cfg, frames, device):
    from raytracingpbr_tpu_torch.core.types import make_frame_state
    from raytracingpbr_tpu_torch.ops.integrator import render_frame
    state = make_frame_state(cfg.num_pixels, device)
    for _ in range(frames):
        px, state = render_frame(scene, env, cam, state, cfg)
    r = state.rays
    return (px, state.accum, r.origin, r.direction, r.color, r.depth,
            state.hit_t)


@pytest.mark.parametrize("name", ["tokyo", "cornell"])
def test_frames_through_the_normal_kernel_bit_equal(cuda_device, name,
                                                    monkeypatch):
    """Three wavefront frames with the normal kernel and with autograd's
    normal in its place: every pixel, accumulator and ray bit for bit."""
    if name == "tokyo":
        scene, env = (demo.scene_demo_scene(cuda_device),
                      demo.tokyo_environment(device=cuda_device))
        cfg = demo.tokyo_config().replace(resolution=(320, 180))
        cam = demo.engine_camera(cuda_device)
    else:
        scene, env = cornell.full_scene(cuda_device), cornell.sky(cuda_device)
        cfg = cornell.full_config().replace(resolution=(160, 160))
        cam = cornell.full_camera(cuda_device)
    normal_kernel.reset_launches()
    got = _frames_state(scene, env, cam, cfg, 3, cuda_device)
    assert normal_kernel.LAUNCHES["normal"] > 0
    monkeypatch.setattr(normal_kernel, "calc_normal",
                        scenelib.calc_normal_autograd)
    want = _frames_state(scene, env, cam, cfg, 3, cuda_device)
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))


# --- the material gradient kernel (csrc/material_grad.cu) --------------------

# case: (lanes, objects, parts needing a gradient, how the gradients come)
MATERIAL_CASES = {
    "glass_albedo": (2_073_600, 1, ("albedo",), "dense"),
    "glass_all": (2_073_600, 1, material_grad_kernel.PART_NAMES, "dense"),
    "cornell_albedo": (230_400, 8, ("albedo",), "dense"),
    "cornell_all": (230_400, 8, material_grad_kernel.PART_NAMES, "int64"),
    "ragged": (1_000_003, 7, ("albedo", "roughness"), "dense"),
    "strided": (65_537, 8, ("albedo", "emission", "ior"), "strided"),
    "undefined": (4_097, 3, ("albedo", "roughness"), "undefined"),
    "many_objects": (100_003, 128, material_grad_kernel.PART_NAMES, "dense"),
}


def _material_inputs(case, device):
    """The case's lanes (int32 object ids, or int64), field gradients
    drawn about 1 (so an object's sum is of its absolute sum's size) in
    the case's layout, and the parts' needs."""
    n, n_obj, names, how = MATERIAL_CASES[case]
    gen = torch.Generator(device=device).manual_seed(n + n_obj)
    idx = torch.randint(0, n_obj, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    if how == "int64":
        idx = idx.to(torch.int64)
    grads = []
    for name, k in zip(material_grad_kernel.PART_NAMES,
                       material_grad_kernel.PART_WIDTHS):
        shape = (n, k) if k > 1 else (n,)
        g = 1.0 + torch.randn(shape, generator=gen, device=device)
        if how == "strided":
            # every other row of a wider tensor; the ior's one value
            # broadcast over the lanes
            wide = 1.0 + torch.randn((2 * n, k + 1), generator=gen,
                                     device=device)
            g = (g[:1].expand(n) if name == "ior"
                 else wide[::2, :k].reshape(shape))
            assert not g.is_contiguous()
        grads.append(None if how == "undefined" and name == "albedo"
                     else g)
    needs = [k in names for k in material_grad_kernel.PART_NAMES]
    return idx, grads, needs, n_obj


@pytest.mark.parametrize("case", sorted(MATERIAL_CASES))
def test_material_grad_kernel_against_plain(cuda_device, case):
    """The kernel's gradients against the plain backward (``index_add_``,
    float atomics) and against a float64 sum, per (object, column) with A
    that entry's sum of absolute values: within 1e-5 A of float64 (the
    kernel adds each value at most about 40 times, 40 x 2^-24 = 2.4e-6),
    and within 1e-5 A + 4 sqrt(n) 2^-24 A of the plain backward, whose
    serial atomics in a random order drift by about sqrt(n) 2^-24 / 3.
    An undefined gradient reads as zeros; parts not needed get None."""
    idx, grads, needs, n_obj = _material_inputs(case, cuda_device)
    got = material_grad_kernel.material_grad_cuda(idx, grads, needs, n_obj)
    plain = material_grad_kernel.material_grad_plain(
        idx, grads, needs, n_obj, torch.float32)
    f64 = material_grad_kernel.material_grad_plain(
        idx, [None if g is None else g.double() for g in grads], needs,
        n_obj, torch.float64)
    size = material_grad_kernel.material_grad_plain(
        idx, [None if g is None else g.double().abs() for g in grads],
        needs, n_obj, torch.float64)
    n = idx.shape[0]
    for g, p, r, a, need in zip(got, plain, f64, size, needs):
        if not need:
            assert g is None and p is None
            continue
        assert g.dtype == torch.float32 and g.shape == r.shape
        err = (g.double() - r).abs()
        assert bool((err <= 1e-5 * a).all()), float((err / a).max())
        tol = (1e-5 + 4 * n ** 0.5 * 2.0 ** -24) * a
        assert bool(((g.double() - p.double()).abs() <= tol).all())
    if case == "undefined":
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("case", ["glass_all", "cornell_albedo", "ragged"])
def test_material_grad_kernel_repeats_bit_for_bit(cuda_device, case):
    """No atomics: two calls on the same inputs give the same bits."""
    idx, grads, needs, n_obj = _material_inputs(case, cuda_device)
    a = material_grad_kernel.material_grad_cuda(idx, grads, needs, n_obj)
    b = material_grad_kernel.material_grad_cuda(idx, grads, needs, n_obj)
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


def test_material_grad_kernel_without_a_host_sync(cuda_device):
    """The wrapper runs under ``set_sync_debug_mode("error")``, one call
    counted each; an empty lane set gives zeros."""
    idx, grads, needs, n_obj = _material_inputs("cornell_albedo",
                                                cuda_device)
    material_grad_kernel.material_grad_cuda(idx, grads, needs, n_obj)
    torch.cuda.synchronize()
    material_grad_kernel.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            material_grad_kernel.material_grad_cuda(idx, grads, needs, n_obj)
        empty = material_grad_kernel.material_grad_cuda(
            idx[:0], [g[:0] for g in grads], needs, n_obj)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert material_grad_kernel.LAUNCHES == {"material_grad": 4}
    assert torch.equal(empty[0], torch.zeros((n_obj, 3), device=cuda_device))


def test_material_grad_kernel_refuses(cuda_device):
    """float64 gradients, a gradient of the wrong lane count, and more
    objects than the kernel holds raise ValueError."""
    idx, grads, needs, n_obj = _material_inputs("undefined", cuda_device)
    bad = {"float64": [g if g is None else g.double() for g in grads],
           "lanes": [g if g is None else g[1:] for g in grads]}
    for gs in bad.values():
        with pytest.raises(ValueError):
            material_grad_kernel.material_grad_cuda(idx, gs, needs, n_obj)
    with pytest.raises(ValueError, match="objects"):
        material_grad_kernel.material_grad_cuda(idx, grads, needs, 129)


def test_materials_at_backward_launches_once(cuda_device):
    """One backward of ``materials_at`` with a leaf on the card: one
    kernel call, whose gradient is the kernel's on the field gradients."""
    scene = cornell.full_scene(cuda_device)
    albedo = scene.albedo.clone().requires_grad_(True)
    idx = torch.randint(0, 8, (230_400,), device=cuda_device,
                        dtype=torch.int32)
    material_grad_kernel.reset_launches()
    mat = scenelib.materials_at(scene.replace(albedo=albedo), idx)
    assert [f.requires_grad for f in mat] == [True] + [False] * 5
    up = torch.randn((230_400, 3), device=cuda_device)
    (g,) = torch.autograd.grad(mat.albedo, albedo, up)
    assert material_grad_kernel.LAUNCHES == {"material_grad": 1}
    want = material_grad_kernel.material_grad_cuda(
        idx, [up] + [None] * 5, [True] + [False] * 5, 8)[0]
    assert torch.equal(g, want)


def test_cornell_grad_step_routes_on_the_card(cuda_device, monkeypatch):
    """A Cornell scan-AD step at 64x64, 8 bounces, albedo leaf: 16
    ``materials_at`` calls through the Function, 8 kernel calls (the
    shading's gather; the emission's needs no backward), the 8 normals
    on the normal kernel; the gradient within rtol 1e-5 of the same step
    with the plain backward (``index_add_``) in the kernel's place."""
    from raytracingpbr_tpu_torch.parallel import train as ptrain
    scene = cornell.full_scene(cuda_device)
    cfg = cornell.full_config().replace(resolution=(64, 64), max_raytrace=8)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=cuda_device)

    def step():
        albedo = scene.albedo.clone().requires_grad_(True)
        img = ptrain.render_pixels(scene.replace(albedo=albedo),
                                   cornell.sky(cuda_device),
                                   cornell.full_camera(cuda_device), pid,
                                   cfg, 1)
        return torch.autograd.grad(img.square().mean(), albedo)[0]

    routes = (dict(scenelib.NORMAL_ROUTES), dict(scenelib.MATERIAL_ROUTES))
    material_grad_kernel.reset_launches()
    got = step()
    normal = {k: v - routes[0][k] for k, v in scenelib.NORMAL_ROUTES.items()}
    material = {k: v - routes[1][k]
                for k, v in scenelib.MATERIAL_ROUTES.items()}
    assert normal == {"kernel": 8, "autograd_first_order": 0,
                      "autograd_second_order": 0}
    assert material == {"plain_gather": 0, "function": 16}
    assert material_grad_kernel.LAUNCHES == {"material_grad": 8}
    monkeypatch.setattr(
        material_grad_kernel, "material_grad_cuda",
        lambda idx, grads, needs, n_obj: material_grad_kernel
        .material_grad_plain(idx, grads, needs, n_obj, torch.float32))
    want = step()
    assert material_grad_kernel.LAUNCHES == {"material_grad": 8}
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-7 * float(want.abs().max()))
