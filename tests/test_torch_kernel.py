"""The CUDA march kernel (K1a) against the plain PyTorch march on the card.

Built with -fmad=false and without fast math, the kernel rounds every add
and multiply as PyTorch's elementwise CUDA ops do, in the same order, so
all eight outputs must be bit-equal. These tests need a CUDA device and
skip without one; this file imports no jax, so it runs on a machine that
has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.kernels import march_kernel
from raytracingpbr_tpu_torch.models import cornell
from raytracingpbr_tpu_torch.ops import camera as tcamera
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.ops.scene import ObjectSpec, make_scene
from raytracingpbr_tpu_torch.ops.sdf import SHAPE

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
    before = march_kernel.LAUNCHES
    k = tmarch.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=active, init=init))
    assert march_kernel.LAUNCHES == before + (1 if o.shape[0] else 0)
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
    before = march_kernel.LAUNCHES
    tmarch.march_resumable(scene, o, d, mcfg)
    assert march_kernel.LAUNCHES == before + 1


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
