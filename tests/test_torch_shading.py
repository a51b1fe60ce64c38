"""Port camera, shading, sky and post against JAX on the same inputs.

Tolerance rtol 1e-5: same formulas, but XLA-CPU fuses and contracts
multiply-adds (and lowers tan/pow/normalize its own way) where PyTorch
rounds every operation, so results differ in the last ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.config import Tonemap as JTonemap
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import camera as jcamera
from raytracingpbr_tpu.ops import ibl as jibl
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu.ops import post as jpost
from raytracingpbr_tpu.ops import shade as jshade
from raytracingpbr_tpu_torch.convert import (camera_from_jax, config_from_jax,
                                             environment_from_jax,
                                             scene_from_jax)
from raytracingpbr_tpu_torch.ops import camera as tcamera
from raytracingpbr_tpu_torch.ops import ibl as tibl
from raytracingpbr_tpu_torch.ops import post as tpost
from raytracingpbr_tpu_torch.ops import shade as tshade

from .torch_helpers import CPU, nn, random_rays, tt

RTOL = 1e-5
N = 4096


def _close(got, ref, atol=1e-6):
    np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=RTOL,
                               atol=atol)


def test_camera_rays_match():
    cfg = jcornell.full_config().replace(resolution=(64, 64))
    rng = np.random.default_rng(0)
    pid = rng.integers(0, cfg.num_pixels, N).astype(np.uint32)
    u = rng.random((4, N), dtype=np.float32)
    juv = jcamera.pixel_uv(jnp.asarray(pid), cfg.width, cfg.height,
                           jnp.asarray(u[0]), jnp.asarray(u[1]))
    tuv = tcamera.pixel_uv(tt(pid.astype(np.int64)), cfg.width, cfg.height,
                           tt(u[0]), tt(u[1]))
    _close(tuv, juv)
    for jcam in (jcornell.full_camera(), jcornell.minimal_camera()):
        ref = jcamera.get_ray(jcam, juv, jnp.asarray(u[2]),
                              jnp.asarray(u[3]))
        got = tcamera.get_ray(camera_from_jax(jcam, CPU), tuv, tt(u[2]),
                              tt(u[3]))
        _close(got.origin, ref.origin)
        _close(got.direction, ref.direction)
        _close(got.color, ref.color)
        np.testing.assert_array_equal(nn(got.depth), np.asarray(ref.depth))


def test_fresnel_matches():
    rng = np.random.default_rng(1)
    no_i, f0, r = rng.uniform(-1, 1, (3, N)).astype(np.float32)
    f0, r = np.abs(f0), np.abs(r)
    _close(tshade.fresnel_schlick(tt(no_i), tt(f0)),
           jshade.fresnel_schlick(jnp.asarray(no_i), jnp.asarray(f0)))
    _close(tshade.fresnel_schlick_roughness(tt(no_i), tt(f0), tt(r)),
           jshade.fresnel_schlick_roughness(jnp.asarray(no_i),
                                            jnp.asarray(f0), jnp.asarray(r)))


@pytest.mark.parametrize("flags", [
    dict(),  # the wavefront's src variant: fold, normal-offset restart
    dict(roughness_fresnel=True, restart_at_hit=True),  # example variant
    dict(roughness_fresnel=True, reflect_kill=False),
])
def test_surface_interaction_matches(flags):
    js = jcornell.full_scene()
    jcfg = jcornell.full_config()
    o, d = random_rays(N, seed=2, center=(0.0, 0.0, 0.5), spread=0.3)
    res = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), jcfg,
                       differentiable=False, backend="xla")
    hit = np.asarray(res.hit)
    pos = np.asarray(res.position)[hit]
    idx = np.asarray(res.index)[hit]
    dirs = d[hit]
    u = np.random.default_rng(3).random((4, hit.sum()), dtype=np.float32)
    ref = jshade.ray_surface_interaction(
        js, jnp.asarray(idx), jnp.asarray(pos), jnp.asarray(dirs),
        tuple(jnp.asarray(v) for v in u), jcfg, **flags)
    got = tshade.ray_surface_interaction(
        scene_from_jax(js, CPU), tt(idx), tt(pos), tt(dirs),
        tuple(tt(v) for v in u), config_from_jax(jcfg), **flags)
    for name in ("diffuse", "outer", "killed", "reflect"):
        np.testing.assert_array_equal(nn(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("direction", "origin", "color_scale", "normal"):
        _close(getattr(got, name), getattr(ref, name), atol=1e-5)


@pytest.mark.parametrize("kind", ["black", "white", "constant", "gradient"])
def test_sky_matches(kind):
    make = {"black": jibl.black_sky, "white": jibl.white_sky,
            "constant": lambda: jibl.constant_sky((0.3, 0.6, 0.9)),
            "gradient": jibl.gradient_sky}[kind]
    jenv = make()
    _, d = random_rays(N, seed=4)
    ref = jibl.sky_color(jenv, jnp.asarray(d))
    got = tibl.sky_color(environment_from_jax(jenv, CPU), tt(d))
    _close(got, ref)


def test_hdr_sky_raises():
    """An HDR environment without its image raises (the HDR lookup itself
    is held against JAX in ``tests/test_torch_ibl.py``)."""
    env = tibl.Environment(kind=tibl.SkyKind.HDR.value)
    with pytest.raises(ValueError):
        tibl.sky_color(env, tt(np.zeros((4, 3), np.float32)))


@pytest.mark.parametrize("order", list(JTonemap))
def test_tonemap_and_post_match(order):
    rng = np.random.default_rng(5)
    accum = np.concatenate([rng.gamma(1.0, 2.0, (N, 3)),
                            rng.integers(0, 5, (N, 1))], -1)
    accum = accum.astype(np.float32)
    jcfg = jcornell.full_config().replace(tonemap=order,
                                          adaptive_sampling=True)
    tcfg = config_from_jax(jcfg)
    rgb = accum[:, :3]
    _close(tpost.aces_fitted(tt(rgb)), jpost.aces_fitted(jnp.asarray(rgb)))
    _close(tpost.tonemap(tt(rgb), tcfg, 0.6),
           jpost.tonemap(jnp.asarray(rgb), jcfg, 0.6))
    last = rng.random((N, 3)).astype(np.float32)
    diff = np.ones((N, 2), np.float32) + rng.random((N, 2)).astype(np.float32)
    ref = jpost.post_process(jnp.asarray(accum), jcfg, 0.6,
                             last_pixels=jnp.asarray(last),
                             diff_accum=jnp.asarray(diff))
    got = tpost.post_process(tt(accum), tcfg, 0.6, last_pixels=tt(last),
                             diff_accum=tt(diff))
    for g, r in zip(got, ref):
        _close(g, r)
    # without adaptive sampling the noise buffers pass through
    plain = tpost.post_process(tt(accum), tcfg.replace(
        adaptive_sampling=False), 0.6, last_pixels=tt(last),
        diff_accum=tt(diff))
    assert plain[2] is None
