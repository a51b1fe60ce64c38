"""The port's megakernel integrator (``ops/integrator.megakernel_trace``,
``render_image``) against the JAX package on the CPU.

* ``render_image(diffuse_only=True)`` on the minimal Cornell box against
  ``tests/oracle.py``'s sequential numpy renderer, and on the full Cornell
  box and the glass bunny against JAX ``render_image``, at the bar of
  ``tests/test_integrator.py``'s oracle test: at least 98% of pixels within
  atol 2e-3 and rtol 1e-3, means within 2e-3;
* ``megakernel_trace`` on rays converted from JAX: bounce counts equal on
  at least 99% of lanes, colours at the same bar;
* ``rng.sampler4`` and the uint32 counters bit-exact to JAX, the bounce
  counter ``sample_idx * max_raytrace + i`` past 2**32 included;
* asking whether a lane is alive every bounce or every k bounces gives the
  same output bit for bit;
* ``cfg.env_sampling`` without a baked table raises JAX's ValueError;
  the gradient modes give the forward's numbers, ``cfg.reprojection``
  raises, and the ``march`` and ``reflect_kill`` defaults are the
  reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import camera as jcamera
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import integrator as tinteg

from .oracle import OracleCornell
from .torch_helpers import CPU, nn, tt

FULL = dict(resolution=(16, 16), max_raymarch=160, max_raytrace=12)


def assert_image_bar(got, ref):
    """``tests/test_integrator.py``'s oracle bar."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    frac = np.isclose(got, ref, atol=2e-3, rtol=1e-3).mean()
    assert frac > 0.98, f"only {frac:.3%} of pixels match"
    assert abs(got.mean() - ref.mean()) < 2e-3


def test_minimal_cornell_matches_numpy_oracle():
    w = h = 24
    cfg = tcornell.minimal_config().replace(resolution=(w, h))
    img = tinteg.render_image(tcornell.minimal_scene(CPU), tcornell.sky(CPU),
                              tcornell.minimal_camera(CPU), cfg, spp=2,
                              diffuse_only=True, tonemapped=False)
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    assert_image_bar(nn(img), OracleCornell(w, h).render(2))


def test_full_cornell_matches_jax():
    jcfg = jcornell.full_config().replace(**FULL)
    ref = rt.render_image(jcornell.full_scene(), jcornell.sky(),
                          jcornell.full_camera(), jcfg, spp=2,
                          tonemapped=False)
    got = tinteg.render_image(tcornell.full_scene(CPU), tcornell.sky(CPU),
                              tcornell.full_camera(CPU),
                              convert.config_from_jax(jcfg), spp=2,
                              tonemapped=False)
    assert_image_bar(nn(got), ref)
    assert float(got.max()) > 1.0  # the light was seen


def test_glass_bunny_matches_jax():
    jcfg = jbunny.glass_config(scale=40).replace(max_raymarch=128,
                                                 max_raytrace=8)
    assert jcfg.resolution == (48, 27)
    ref = rt.render_image(jbunny.glass_scene(), jbunny.glass_environment(),
                          jbunny.camera(jcfg.width / jcfg.height), jcfg,
                          spp=1, tonemapped=False)
    cfg = convert.config_from_jax(jcfg)
    got = tinteg.render_image(tbunny.glass_scene(CPU),
                              tbunny.glass_environment(device=CPU),
                              tbunny.camera(cfg.width / cfg.height, CPU),
                              cfg, spp=1, tonemapped=False)
    assert_image_bar(nn(got), ref)


def _jax_primaries(jcfg, sample):
    """JAX camera rays of one sample, as ``render_image`` draws them."""
    pid = jnp.arange(jcfg.num_pixels, dtype=jnp.uint32)
    u = jrng.sampler4(jcfg.low_discrepancy)(pid, jnp.uint32(sample),
                                            jinteg._S_CAMERA, jcfg.seed)
    uv = jcamera.pixel_uv(pid, jcfg.width, jcfg.height, u[0], u[1])
    return pid, jcamera.get_ray(jcornell.full_camera(), uv, u[2], u[3])


def test_megakernel_trace_on_converted_jax_rays():
    jcfg = jcornell.full_config().replace(**FULL)
    pid, rays = _jax_primaries(jcfg, 3)
    ref = jinteg.megakernel_trace(jcornell.full_scene(), jcornell.sky(), rays,
                                  pid, 3, jcfg)
    got = tinteg.megakernel_trace(
        tcornell.full_scene(CPU), tcornell.sky(CPU),
        convert.rays_from_jax(rays, CPU), tt(np.asarray(pid).astype(
            np.int64)), 3, convert.config_from_jax(jcfg))
    assert got.bounces.dtype == torch.int32
    same = (nn(got.bounces) == np.asarray(ref.bounces)).mean()
    assert same >= 0.99, f"bounces equal on only {same:.2%} of lanes"
    assert int(got.bounces.max()) > 1
    assert_image_bar(nn(got.color), ref.color)


@pytest.mark.parametrize("low_discrepancy", [False, True])
@pytest.mark.parametrize("step", [0, 5, 2**32 - 1])
def test_sampler4_bit_exact(low_discrepancy, step):
    pid = np.concatenate([np.arange(512, dtype=np.uint32),
                          (2**32 - 1 - np.arange(512)).astype(np.uint32)])
    assert trng.sampler4(low_discrepancy) is (
        trng.r2_uniform4 if low_discrepancy else trng.uniform4)
    ref = jrng.sampler4(low_discrepancy)(jnp.asarray(pid), jnp.uint32(step),
                                         1, 77)
    got = trng.sampler4(low_discrepancy)(tt(pid.astype(np.int64)), step, 1,
                                         77)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(nn(g), np.asarray(r))


def test_counter_wrap_bit_exact(monkeypatch):
    """Samples ``2**32 - 2`` and ``2**32 - 1``, then ``0`` (the sample index
    wraps too): ``sample_idx * max_raytrace + i`` passes 2**32 on every
    bounce of the first two. The draws the port makes, camera and bounce
    alike, are JAX's at the uint32 counters JAX computes, bit for bit."""
    cfg = tcornell.full_config().replace(resolution=(4, 4), max_raymarch=64,
                                         max_raytrace=12)
    seen = []
    real = trng.uniform4

    def record(pixel_id, step, stream, seed=0, dtype=torch.float32):
        out = real(pixel_id, step, stream, seed, dtype)
        seen.append((step, stream, seed, out))
        return out
    monkeypatch.setattr(trng, "uniform4", record)
    offset = 2**32 - 2
    tinteg.render_image(tcornell.full_scene(CPU), tcornell.sky(CPU),
                        tcornell.full_camera(CPU), cfg, spp=3,
                        sample_offset=offset)
    pid = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    sample, i, bounce_draws = -1, 0, 0
    for step, stream, seed, out in seen:
        idx = jnp.asarray(offset, jnp.uint32) + jnp.uint32(max(sample, 0))
        if stream == tinteg._S_CAMERA:  # a new sample
            sample, i = sample + 1, 0
            want = jnp.asarray(offset, jnp.uint32) + jnp.uint32(sample)
        else:  # roulette, then shading, on bounce i's counter
            want = idx * jnp.uint32(cfg.max_raytrace) + jnp.uint32(i)
            if sample < 2:
                assert (offset + sample) * cfg.max_raytrace + i >= 2**32
            bounce_draws += 1
            i += stream == tinteg._S_SHADE
        assert step == int(want), (sample, i, stream, step, int(want))
        ref = jrng.uniform4(pid, want, stream, seed)
        for r, g in zip(ref, out):
            np.testing.assert_array_equal(nn(g), np.asarray(r))
    assert sample == 2 and bounce_draws > 6


def test_early_exit_check_every_k_bit_identical(monkeypatch):
    """A bounce with no lane alive changes nothing, so the loop may ask the
    card every k bounces (``EXIT_CHECK_EVERY``): k = 1, 3 and 8 give the
    same image and bounce counts bit for bit, and the sample ends before
    max_raytrace."""
    cfg = tcornell.full_config().replace(resolution=(12, 12),
                                         max_raymarch=128, max_raytrace=40)
    scene, env, cam = (tcornell.full_scene(CPU), tcornell.sky(CPU),
                       tcornell.full_camera(CPU))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64)
    u = trng.uniform4(pid, 9, tinteg._S_CAMERA, cfg.seed)
    from raytracingpbr_tpu_torch.ops import camera as tcamera
    rays = tcamera.get_ray(cam, tcamera.pixel_uv(pid, cfg.width, cfg.height,
                                                 u[0], u[1]), u[2], u[3])
    def with_k(k, fn, *args, **kw):
        monkeypatch.setattr(tinteg, "EXIT_CHECK_EVERY", k)
        return fn(*args, **kw)
    outs = [with_k(k, tinteg.megakernel_trace, scene, env, rays, pid, 9, cfg)
            for k in (1, 3, 8)]
    for o in outs[1:]:
        assert torch.equal(o.color, outs[0].color)
        assert torch.equal(o.bounces, outs[0].bounces)
    assert int(outs[0].bounces.max()) < cfg.max_raytrace - 3
    imgs = [with_k(k, tinteg.render_image, scene, env, cam, cfg, spp=2)
            for k in (1, 5)]
    assert torch.equal(imgs[0], imgs[1])


def test_render_image_with_compaction_is_bit_identical():
    """``march_compaction``, which the benchmark's configuration files
    carry, changes no bit of the megakernel's image: the march is one call
    either way (``test_march_equals_jax_phased_march`` in
    ``tests/test_torch_march.py`` holds that call to the JAX package's
    phased march)."""
    cfg = tcornell.full_config().replace(resolution=(12, 12),
                                         max_raymarch=256, max_raytrace=6)
    args = (tcornell.full_scene(CPU), tcornell.sky(CPU),
            tcornell.full_camera(CPU))
    ref = tinteg.render_image(*args, cfg, spp=2, tonemapped=False)
    got = tinteg.render_image(*args, cfg.replace(march_compaction=True),
                              spp=2, tonemapped=False)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["differentiable", "replay"])
def test_unported_modes_raise(mode):
    """The gradient modes, once unported, now run: ``render_image`` and
    ``megakernel_trace`` with ``differentiable`` True (scan-AD) or
    ``"replay"`` give the forward render's numbers bit for bit at a pinned
    ``reflect_kill``. ``cfg.reprojection``, once unported, is ignored by
    the megakernel as the JAX package's ignores it: the same bits."""
    cfg = tcornell.full_config().replace(resolution=(6, 6), max_raymarch=96,
                                         max_raytrace=6)
    kw = {"differentiable": True if mode == "differentiable" else "replay"}
    args = (tcornell.full_scene(CPU), tcornell.sky(CPU))
    cam = tcornell.full_camera(CPU)
    ref_image = tinteg.render_image(*args, cam, cfg, reflect_kill=False,
                                    tonemapped=False)
    got = tinteg.render_image(*args, cam, cfg, reflect_kill=False,
                              tonemapped=False, **kw)
    assert torch.equal(got, ref_image)
    pid = torch.arange(cfg.num_pixels)
    u = trng.uniform4(pid, 0, 1, cfg.seed)
    from raytracingpbr_tpu_torch.ops import camera as tcamera
    rays = tcamera.get_ray(cam, tcamera.pixel_uv(pid, cfg.width, cfg.height,
                                                 u[0], u[1]), u[2], u[3])
    ref = tinteg.megakernel_trace(*args, rays, pid, 0, cfg,
                                  reflect_kill=False)
    got = tinteg.megakernel_trace(*args, rays, pid, 0, cfg,
                                  reflect_kill=False, **kw)
    assert torch.equal(got.color, ref.color)
    got = tinteg.render_image(*args, cam, cfg.replace(reprojection=True),
                              reflect_kill=False, tonemapped=False, **kw)
    assert torch.equal(got, ref_image)


def test_march_and_reflect_kill_defaults_match_jax():
    """The repaired defaults: ``march(differentiable=...)`` defaults to
    True as the reference's does, and ``megakernel_trace``'s
    ``reflect_kill`` to ``roughness_fresnel and not differentiable``: the
    scan-AD forward folds a below-surface reflection back above, so its
    colours follow JAX's scan-AD forward (``differentiable=True``) and not
    the killing forward render, from which they differ on some lanes."""
    import inspect

    from raytracingpbr_tpu.ops import march as jmarch
    from raytracingpbr_tpu_torch.ops import march as tmarch
    default = lambda f: inspect.signature(f).parameters[
        "differentiable"].default
    assert default(tmarch.march) is default(jmarch.march) is True
    jcfg = jcornell.full_config().replace(**FULL)
    jscene, jenv = jcornell.full_scene(), jcornell.sky()
    pid = jnp.arange(jcfg.num_pixels, dtype=jnp.uint32)
    u = jrng.uniform4(pid, 0, 1, jcfg.seed)
    jrays = jcamera.get_ray(jcornell.full_camera(), jcamera.pixel_uv(
        pid, jcfg.width, jcfg.height, u[0], u[1]), u[2], u[3])
    want = jinteg.megakernel_trace(jscene, jenv, jrays, pid, 0, jcfg,
                                   differentiable=True).color
    args = (tcornell.full_scene(CPU), tcornell.sky(CPU),
            convert.rays_from_jax(jrays, CPU), torch.arange(jcfg.num_pixels),
            0, convert.config_from_jax(jcfg))
    got = tinteg.megakernel_trace(*args, differentiable=True).color
    killing = tinteg.megakernel_trace(*args).color
    assert_image_bar(nn(got), np.asarray(want))
    assert not torch.equal(got, killing)
    assert torch.equal(got, tinteg.megakernel_trace(
        *args, reflect_kill=False).color)


def test_env_sampling_requires_baked_table():
    """JAX's error (``tests/test_nee.py:327-331``): ``cfg.env_sampling``
    with an HDR environment that has no baked alias table raises
    ValueError, in ``render_image`` and in ``megakernel_trace``."""
    from .test_torch_nee_stats import CAM, base_cfg, sun_env, sun_scene
    cfg = base_cfg(env_sampling=True)
    with pytest.raises(ValueError, match="alias"):
        tinteg.render_image(sun_scene(), sun_env(), CAM, cfg, spp=1)
    from raytracingpbr_tpu_torch.ops import camera as tcamera
    pid = torch.arange(cfg.num_pixels)
    u = trng.uniform4(pid, 0, 1, 0)
    rays = tcamera.get_ray(CAM, tcamera.pixel_uv(pid, cfg.width, cfg.height,
                                                 u[0], u[1]), u[2], u[3])
    with pytest.raises(ValueError, match="alias"):
        tinteg.megakernel_trace(sun_scene(), sun_env(), rays, pid, 0, cfg)
