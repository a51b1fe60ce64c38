"""The port's plain march on the K1b and K1c variants against JAX.

* Bunny rays (the recipe of ``tests/test_pallas.py::
  test_pallas_bunny_matches_xla``: 1024 lanes aimed at the bunny, budget
  256) against JAX's XLA march: at least 99% hit agreement, t within rtol
  2e-3 on lanes both call a hit — the port marches the MLP in the kernel's
  order, JAX with dots, so a long march can flip a grazing lane.
* One budget-32 resume on bunny rays against the TPU kernel itself
  (``_march_pallas_impl`` in interpret mode, gated, from a seeded init), at
  ``tests/test_torch_march.py``'s bars.
* The K1b variants (engine: ROLLBACK_TO_ONE + CONE; scene_demo:
  ROLLBACK_TO_ONE + RELATIVE; tokyo: ROLLBACK_HALF_UP + RELATIVE; the
  escape bound) against JAX's XLA march at the same bars, on engine-camera
  primaries and the reference's random-ray recipe. (A wider spread puts
  origins deep inside the radius-100 ground sphere, where ``|p - c| - 100``
  cancels in f32: with spread 0.3, one lane of 2048 rounded a distance to
  exactly 0 on one side only and stopped 85 units early.)
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import camera as jcamera
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu_torch.convert import config_from_jax, scene_from_jax
from raytracingpbr_tpu_torch.kernels import march_kernel
from raytracingpbr_tpu_torch.ops import march as tmarch

from .test_torch_march import _assert_march_bars
from .torch_helpers import CPU, nn, random_rays, tt


def bunny_rays(n=1024, seed=3):
    """Rays from about (0, 0, 2.5) aimed at the bunny, with a spread."""
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, 0.0, 2.5]], (n, 1)) + rng.normal(0, 0.1, (n, 3))
    d = -o + rng.normal(0, 0.35, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("animated", [False, True])
def test_plain_bunny_march_matches_jax(animated):
    js = jbunny.glass_scene()
    if animated:
        js = jbunny.animated_scene(js, 60)
    jcfg = jbunny.glass_config(scale=8).replace(max_raymarch=256)
    o, d = bunny_rays()
    ref = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), jcfg,
                       differentiable=False, backend="xla")
    got = tmarch.march(scene_from_jax(js, CPU), tt(o), tt(d),
                       config_from_jax(jcfg))
    h_ref, h_got = np.asarray(ref.hit), nn(got.hit)
    assert h_ref.mean() > 0.2  # a fair share of the lanes hit the bunny
    assert (h_ref == h_got).mean() >= 0.99
    both = h_ref & h_got
    np.testing.assert_allclose(nn(got.t)[both], np.asarray(ref.t)[both],
                               rtol=2e-3, atol=2e-3)


def test_plain_bunny_resume_matches_pallas_interpret(monkeypatch):
    """The TPU kernel's bunny path (Pallas in interpret mode, resume +
    gate) against the port's plain resumable march."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    js = jbunny.glass_scene()
    jcfg = jbunny.glass_config(scale=8).replace(max_raymarch=32)
    o, d = bunny_rays(seed=5)
    n = o.shape[0]
    rng = np.random.default_rng(8)
    active = rng.random(n) < 0.8
    init = (rng.uniform(0.005, 1.2, n).astype(np.float32),
            np.full(n, 0.5, np.float32),
            rng.uniform(0, 0.1, n).astype(np.float32),
            np.full(n, 1e3, np.float32))
    ref = jmarch.march_resumable(js, jnp.asarray(o), jnp.asarray(d), jcfg,
                                 active=jnp.asarray(active),
                                 init=tuple(jnp.asarray(v) for v in init),
                                 backend="pallas")
    got = tmarch.march_resumable(scene_from_jax(js, CPU), tt(o), tt(d),
                                 config_from_jax(jcfg), active=tt(active),
                                 init=tuple(tt(v) for v in init))
    _assert_march_bars(ref, got)
    agree = np.asarray(ref.hit) == nn(got.hit)
    for k in ("fin", "done"):
        np.testing.assert_array_equal(nn(getattr(got, k))[agree],
                                      np.asarray(getattr(ref, k))[agree])
    assert nn(got.hit).mean() > 0.1


K1B = {
    "engine": (jdemo.engine_scene, jdemo.engine_config),
    "scene_demo": (jdemo.scene_demo_scene, jdemo.scene_demo_config),
    "tokyo": (jdemo.engine_scene, jdemo.tokyo_config),
    "engine_bound": (jdemo.engine_scene,
                     lambda: jdemo.engine_config().replace(
                         escape_bound=True)),
}


def engine_primaries(cfg):
    """Primary rays of the engine camera (numpy), as the JAX package makes
    them."""
    pid = np.arange(cfg.num_pixels, dtype=np.uint32)
    u = jrng.uniform4(jnp.asarray(pid), 0, 1, cfg.seed)
    uv = jcamera.pixel_uv(jnp.asarray(pid), cfg.width, cfg.height, u[0],
                          u[1])
    rays = jcamera.get_ray(jdemo.engine_camera(), uv, u[2], u[3])
    return np.asarray(rays.origin), np.asarray(rays.direction)


@pytest.mark.parametrize("case", sorted(K1B))
def test_k1b_variants_plain_match_jax(case):
    """Engine-camera primaries and the reference's random-ray recipe
    (``tests/test_pallas.py::rays_for``: about (0, 0, 3.5), spread 0.2)."""
    make_scene, make_cfg = K1B[case]
    js = make_scene()
    jcfg = make_cfg().replace(resolution=(48, 27), max_raymarch=128)
    o1, d1 = engine_primaries(jcfg)
    o2, d2 = random_rays(2048, seed=4, center=(0.0, 0.0, 3.5))
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    ref = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), jcfg,
                       differentiable=False, backend="xla")
    ts, tcfg = scene_from_jax(js, CPU), config_from_jax(jcfg)
    assert march_kernel.variant(ts, tcfg) == "k1b"
    got = tmarch.march(ts, tt(o), tt(d), tcfg)
    _assert_march_bars(ref, got)
    assert nn(got.hit).mean() > 0.3
