"""The port's NEE estimator against its own plain estimator, on the CPU, at
the statistical bars of ``tests/test_nee.py`` with its scenes, sizes,
sample counts and seeds:

* sun-lit, example materials: means within rel 0.25 and the per-pixel
  variance below half (``:110-113``);
* sun-lit, the src engine's materials, 4 seeds x 256 spp: means within
  rel 0.1 (``:133``);
* EXP roulette that kills (light_quality 16): means within rel 0.15
  (``:156``);
* the glossy all-metal scene: means within rel 0.25, variance below half
  (``:217-220``), and specular MIS below 0.6x the variance of diffuse-only
  NEE (``:240``).

The spp samples of a seed are traced as one batch, each lane with its own
sample index (``megakernel_trace`` takes a tensor of them); a lane's
counters, and so its path, are those of ``render_image``'s loop, which the
first test checks at the image bar.
"""
import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch import (HitCriterion, OmegaPolicy, RenderConfig,
                                     Roulette, make_camera, make_scene)
from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.ops import camera as tcamera
from raytracingpbr_tpu_torch.ops import ibl as tibl
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.ops.scene import ObjectSpec
from raytracingpbr_tpu_torch.ops.sdf import SHAPE

from .test_torch_megakernel import assert_image_bar
from .torch_helpers import CPU, nn


def sun_env(front=False):
    img = np.full((32, 16, 3), 0.05, np.float32)
    if front:
        img[24:28, 11:15] = 25.0
    else:
        img[8:12, 11:15] = 25.0
    return tibl.hdr_environment(img, prebake=False, device=CPU)


def sun_scene():
    return make_scene([
        ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
                   albedo=(0.7, 0.7, 0.7), roughness=1.0),
        ObjectSpec(SHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
                   albedo=(0.6, 0.4, 0.3), roughness=1.0),
    ], device=CPU)


def glossy_scene():
    return make_scene([
        ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
                   albedo=(0.7, 0.7, 0.7), roughness=0.8, metallic=1.0),
        ObjectSpec(SHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
                   albedo=(0.9, 0.9, 0.9), roughness=0.5, metallic=1.0),
    ], device=CPU)


CAM = make_camera(lookfrom=(0, 1.0, 4.0), lookat=(0, 0, 0), vfov=40.0,
                  aspect=1.0, aperture=0.0, focus=1.0, device=CPU)


def base_cfg(**kw):
    d = dict(resolution=(12, 12), max_raymarch=48, max_raytrace=4,
             light_quality=1e9, roulette=Roulette.EXP,
             omega=1.0, omega_policy=OmegaPolicy.CONSTANT,
             hit_criterion=HitCriterion.ABSOLUTE, hit_precision=1e-4,
             march_t0=0.005, max_dis=300.0)
    d.update(kw)
    return RenderConfig(**d)


def render(scene, env, cfg, spp, **kw):
    """``render_image(spp=spp, tonemapped=False)``'s per-pixel mean, its
    samples traced as one batch; flat (N, 3)."""
    n = cfg.num_pixels
    pid = torch.arange(n).repeat(spp)
    s = torch.arange(spp).repeat_interleave(n)
    u = trng.uniform4(pid, s, tinteg._S_CAMERA, cfg.seed)
    uv = tcamera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = tcamera.get_ray(CAM, uv, u[2], u[3])
    color = tinteg.megakernel_trace(scene, env, rays, pid, s, cfg,
                                    **kw).color
    return nn(color.reshape(spp, n, 3).mean(0))


def test_batched_samples_match_render_image():
    scene, env = sun_scene(), tibl.with_env_sampler(sun_env())
    cfg = base_cfg(env_sampling=True, seed=3)
    ref = nn(tinteg.render_image(scene, env, CAM, cfg, spp=4,
                                 tonemapped=False))
    got = render(scene, env, cfg, 4)
    got = got.reshape(cfg.width, cfg.height, 3).transpose(1, 0, 2)[::-1]
    assert_image_bar(got, ref)


def _seeds(scene, env, cfg, k, spp, **kw):
    return np.stack([render(scene, env, cfg.replace(seed=s), spp, **kw)
                     for s in range(k)])


def _mean_and_variance(scene, env, cfg, k=8, spp=8):
    off = _seeds(scene, env, cfg, k, spp)
    on = _seeds(scene, tibl.with_env_sampler(env),
                cfg.replace(env_sampling=True), k, spp)
    assert on.mean() == pytest.approx(off.mean(), rel=0.25), (on.mean(),
                                                             off.mean())
    v_off, v_on = off.var(axis=0).mean(), on.var(axis=0).mean()
    assert v_on < 0.5 * v_off, (v_on, v_off)


def test_megakernel_mean_and_variance():
    _mean_and_variance(sun_scene(), sun_env(), base_cfg())


def test_megakernel_src_material_mean():
    kw = dict(roughness_fresnel=False, restart_at_hit=False)
    cfg = base_cfg(max_raytrace=8)
    scene, env = sun_scene(), sun_env()
    off = _seeds(scene, env, cfg, 4, 256, **kw).mean()
    on = _seeds(scene, tibl.with_env_sampler(env),
                cfg.replace(env_sampling=True), 4, 256, **kw).mean()
    assert on == pytest.approx(off, rel=0.1), (on, off)


def test_megakernel_mean_realistic_roulette():
    cfg = base_cfg(max_raytrace=8, light_quality=16.0)
    scene, env = sun_scene(), sun_env()
    off = _seeds(scene, env, cfg, 6, 32).mean()
    on = _seeds(scene, tibl.with_env_sampler(env),
                cfg.replace(env_sampling=True), 6, 32).mean()
    assert on == pytest.approx(off, rel=0.15), (on, off)


def test_glossy_mean_and_variance():
    _mean_and_variance(glossy_scene(), sun_env(front=True),
                       base_cfg(max_raytrace=6))


def test_mis_beats_diffuse_only_nee_on_glossy():
    env = tibl.with_env_sampler(sun_env(front=True))
    cfg = base_cfg(max_raytrace=6, env_sampling=True)

    def var_of(c):
        return _seeds(glossy_scene(), env, c, 8, 8).var(axis=0).mean()
    v_mis, v_no = var_of(cfg), var_of(cfg.replace(mis_specular=False))
    assert v_mis < 0.6 * v_no, (v_mis, v_no)


def test_env_sampling_requires_baked_table():
    with pytest.raises(ValueError, match="alias"):
        render(sun_scene(), sun_env(), base_cfg(env_sampling=True), 1)
