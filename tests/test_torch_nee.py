"""The port's environment sampling (NEE/MIS) against the JAX package on the
CPU, from the same seeded numpy inputs:

* the alias tables (``s_prob``, ``s_alias``, ``s_pdf``) of every sky the
  repository samples bit-equal to JAX's;
* ``sample_env_baked`` (centre and jittered), ``sample_env_alias``,
  ``sample_env`` and ``env_pdf`` at rtol 1e-6, the bar of
  ``tests/test_nee.py:70-72``;
* ``diffuse_lobe_prob`` and ``specular_env_density`` at rtol 1e-5 / atol
  1e-6;
* ``_nee_env``'s bank and visibility on JAX's own hit points;
* ``render_image`` with ``cfg.env_sampling`` at
  ``tests/test_integrator.py``'s image bar (both material variants, the
  diffuse-only shading and the glossy MIS scene);
* the sampler's draw frequencies (``tests/test_nee.py:87``) and the
  specular density's integral (``:282``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import ibl as jibl
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu.ops import shade as jshade
from raytracingpbr_tpu.ops.scene import ObjectSpec as JObjectSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.ops import ibl as tibl
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.ops import shade as tshade

from .test_torch_megakernel import assert_image_bar
from .torch_helpers import CPU, nn, tt


def sun_image(front=False, w=32, h=16):
    """``tests/test_nee.py``'s dim sky with a small bright sun (behind the
    camera, or in front of it for the glossy scene)."""
    img = np.full((w, h, 3), 0.05, np.float32)
    x0 = 3 * w // 4 if front else w // 4
    img[x0:x0 + 4, h - 5:h - 1] = 25.0
    return img


def jax_sun(front=False, w=32, h=16):
    return rt.hdr_environment(jnp.asarray(sun_image(front, w, h)),
                              prebake=False)


def jax_sun_scene():
    return rt.make_scene([
        JObjectSpec(JSHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
                    albedo=(0.7, 0.7, 0.7), roughness=1.0),
        JObjectSpec(JSHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
                    albedo=(0.6, 0.4, 0.3), roughness=1.0),
    ])


def jax_glossy_scene():
    return rt.make_scene([
        JObjectSpec(JSHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
                    albedo=(0.7, 0.7, 0.7), roughness=0.8, metallic=1.0),
        JObjectSpec(JSHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
                    albedo=(0.9, 0.9, 0.9), roughness=0.5, metallic=1.0),
    ])


def jax_glass_scene():
    """A rough dielectric sphere on a plastic floor: the refract lobe, the
    Fresnel roulette at both sides and total internal reflection."""
    return rt.make_scene([
        JObjectSpec(JSHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
                    albedo=(0.7, 0.7, 0.7), roughness=0.3, ior=1.5),
        JObjectSpec(JSHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
                    albedo=(0.9, 0.9, 0.9), roughness=0.2, transmission=1.0,
                    ior=1.5),
    ])


JCAM = rt.make_camera(lookfrom=(0, 1.0, 4.0), lookat=(0, 0, 0), vfov=40.0,
                      aspect=1.0, aperture=0.0, focus=1.0)


def jax_cfg(**kw):
    """``tests/test_nee.py``'s ``base_cfg``."""
    d = dict(resolution=(12, 12), max_raymarch=48, max_raytrace=4,
             light_quality=1e9, roulette=rt.Roulette.EXP,
             omega=1.0, omega_policy=rt.OmegaPolicy.CONSTANT,
             hit_criterion=rt.HitCriterion.ABSOLUTE, hit_precision=1e-4,
             march_t0=0.005, max_dis=300.0)
    d.update(kw)
    return rt.RenderConfig(**d)


SKIES = {
    "sun 32x16": lambda: jax_sun(),
    "bench sun 64x32": lambda: jax_sun(w=64, h=32),
    "engine 192x96": jdemo.engine_environment,
    "tokyo 192x96": jdemo.tokyo_environment,
    "glass 192x96": jbunny.glass_environment,
}


@pytest.mark.parametrize("sky", list(SKIES))
def test_alias_tables_bit_equal(sky):
    env = SKIES[sky]()
    ref = jibl.with_env_sampler(env)
    got = tibl.with_env_sampler(convert.environment_from_jax(env, CPU))
    for k in ("s_prob", "s_alias", "s_pdf"):
        a, b = nn(getattr(got, k)), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    alias = tibl.build_env_alias_sampler(
        convert.environment_from_jax(env, CPU))
    j_alias = jibl.build_env_alias_sampler(env)
    np.testing.assert_array_equal(nn(alias.prob), np.asarray(j_alias.prob))
    np.testing.assert_array_equal(nn(alias.alias),
                                  np.asarray(j_alias.alias))


def test_with_env_sampler_requires_hdr():
    with pytest.raises(ValueError, match="HDR"):
        tibl.with_env_sampler(tibl.white_sky(device=CPU))


def _uniforms(n=257, seed=0):
    u = np.linspace(0.01, 0.99, n).astype(np.float32)
    u2 = ((u * 7.3) % 1.0).astype(np.float32)
    jit = np.random.default_rng(seed).random((2, n)).astype(np.float32)
    return u, u2, jit


def _close(got, ref, rtol=1e-6, atol=0.0):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nn(g), np.asarray(r), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("sky", ["sun 32x16", "engine 192x96"])
def test_samplers_match_jax(sky):
    env = SKIES[sky]()
    j_env = jibl.with_env_sampler(env)
    t_env = convert.environment_from_jax(j_env, CPU)
    u, u2, jit = _uniforms()
    ju, ju2 = jnp.asarray(u), jnp.asarray(u2)
    # centre draws with the second uniform, with u's fraction, jittered
    _close(tibl.sample_env_baked(t_env, tt(u), tt(u2)),
           jibl.sample_env_baked(j_env, ju, ju2))
    _close(tibl.sample_env_baked(t_env, tt(u)),
           jibl.sample_env_baked(j_env, ju))
    got = tibl.sample_env_baked(t_env, tt(u), tt(u2),
                                u_jitter=(tt(jit[0]), tt(jit[1])))
    ref = jibl.sample_env_baked(j_env, ju, ju2, u_jitter=(
        jnp.asarray(jit[0]), jnp.asarray(jit[1])))
    _close(got, ref)
    # the pdf that env_pdf gives at the jittered directions is the draw's
    _close([tibl.env_pdf(t_env, got[0])], [jibl.env_pdf(j_env, ref[0])])
    np.testing.assert_allclose(nn(tibl.env_pdf(t_env, got[0])),
                               nn(got[2]), rtol=1e-5)
    # the alias sampler object and the CDF sampler
    _close(tibl.sample_env_alias(tibl.build_env_alias_sampler(t_env),
                                 tt(u), tt(u2)),
           jibl.sample_env_alias(jibl.build_env_alias_sampler(env), ju,
                                 ju2))
    _close(tibl.sample_env(tibl.build_env_sampler(t_env), tt(u), tt(u2)),
           jibl.sample_env(jibl.build_env_sampler(env), ju, ju2))


def test_baked_sampler_distribution():
    """``tests/test_nee.py:76-88``: the sun patch is drawn with about its
    share of the luminance (the bar: over 0.8 of 200,000 stratified
    draws), and every pdf is positive."""
    env = tibl.with_env_sampler(convert.environment_from_jax(jax_sun(), CPU))
    n = 200_000
    u = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    _, radiance, pdf = tibl.sample_env_baked(env, u)
    assert float((radiance[:, 0] > 1.0).float().mean()) > 0.8
    assert float(pdf.min()) > 0.0


def _shading_inputs(n=512, seed=3):
    """Random incident directions, faced normals, sides, light directions
    and object indices."""
    rng = np.random.default_rng(seed)

    def unit(k):
        v = rng.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)
    normal = unit(n)
    d = unit(n)
    d = np.where((d * normal).sum(-1, keepdims=True) > 0, -d, d)
    omega = unit(n)
    omega[: n // 4] = normal[: n // 4]          # the normal itself
    omega[n // 4: n // 4 + 8] = d[n // 4: n // 4 + 8]  # omega == i
    # near the mirror direction, where even a narrow lobe has density
    mirror = d - 2 * (d * normal).sum(-1, keepdims=True) * normal
    near = mirror + 0.05 * rng.normal(size=mirror.shape)
    near /= np.linalg.norm(near, axis=-1, keepdims=True)
    omega[n // 2:] = near[n // 2:]
    outer = rng.random(n) < 0.7
    index = rng.integers(0, 2, n).astype(np.int32)
    return d, normal, outer, omega, index


SCENES = {"sun": jax_sun_scene, "glossy": jax_glossy_scene,
          "glass": jax_glass_scene}


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("rf,kill", [(False, None), (True, None),
                                     (True, False), (False, True)])
def test_shade_densities_match_jax(name, rf, kill):
    jscene = SCENES[name]()
    tscene = convert.scene_from_jax(jscene, CPU)
    cfg = jax_cfg(f0_half=True)
    tcfg = convert.config_from_jax(cfg)
    d, normal, outer, omega, index = _shading_inputs()
    jin = [jnp.asarray(v) for v in (index, d, normal, outer, omega)]
    tin = [tt(v) for v in (index, d, normal, outer, omega)]
    np.testing.assert_allclose(
        nn(tshade.diffuse_lobe_prob(tscene, *tin, tcfg,
                                    roughness_fresnel=rf)),
        np.asarray(jshade.diffuse_lobe_prob(jscene, *jin, cfg,
                                            roughness_fresnel=rf)),
        rtol=1e-5, atol=1e-6)
    got = nn(tshade.specular_env_density(tscene, *tin, tcfg,
                                         roughness_fresnel=rf,
                                         reflect_kill=kill))
    ref = np.asarray(jshade.specular_env_density(jscene, *jin, cfg,
                                                 roughness_fresnel=rf,
                                                 reflect_kill=kill))
    assert (ref > 0).mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _jax_hit_points(jscene, cfg, seed=0):
    """JAX primaries of the 32x32 view, marched and shaded in JAX: the
    inputs of ``_nee_env`` at each lane's first vertex."""
    n = cfg.num_pixels
    pid = jnp.arange(n, dtype=jnp.uint32)
    u = jrng.uniform4(pid, seed, 1, cfg.seed)
    from raytracingpbr_tpu.ops import camera as jcamera
    uv = jcamera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = jcamera.get_ray(JCAM, uv, u[2], u[3])
    res = jmarch.march(jscene, rays.origin, rays.direction, cfg,
                       differentiable=False)
    u4 = jrng.uniform4(pid, seed, 2, cfg.seed)
    inter = jshade.ray_surface_interaction(jscene, res.index, res.position,
                                           rays.direction, u4, cfg)
    albedo = jscene.albedo[res.index]
    return (res.index, res.position, rays.direction, inter.normal,
            inter.outer, albedo, res.hit, pid)


@pytest.mark.parametrize("name,lobe_prob,mis", [
    ("sun", True, True), ("sun", False, True), ("glossy", True, True),
    ("glossy", True, False), ("glass", True, True)])
def test_nee_env_matches_jax(name, lobe_prob, mis):
    jscene = SCENES[name]()
    env = jibl.with_env_sampler(jax_sun(front=name == "glossy"))
    cfg = jax_cfg(resolution=(32, 32), mis_specular=mis)
    args = _jax_hit_points(jscene, cfg)
    ref, ref_vis = jinteg._nee_env(jscene, env, *args[:7], args[7], 5, cfg,
                                   lobe_prob=lobe_prob)
    targs = [tt(np.asarray(a)) for a in args[:7]]
    pid = tt(np.asarray(args[7]).astype(np.int64))
    got, vis = tinteg._nee_env(convert.scene_from_jax(jscene, CPU),
                               convert.environment_from_jax(env, CPU),
                               *targs, pid, 5, convert.config_from_jax(cfg),
                               lobe_prob=lobe_prob)
    ref_vis = np.asarray(ref_vis)
    assert ref_vis.mean() > 0.2
    np.testing.assert_array_equal(nn(vis), ref_vis)
    np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)


def _render_pair(jscene, env, cfg, spp=2, **kw):
    ref = jinteg.render_image(jscene, env, JCAM, cfg, spp=spp,
                              tonemapped=False, **kw)
    got = tinteg.render_image(convert.scene_from_jax(jscene, CPU),
                              convert.environment_from_jax(env, CPU),
                              convert.camera_from_jax(JCAM, CPU),
                              convert.config_from_jax(cfg), spp=spp,
                              tonemapped=False, **kw)
    return nn(got), np.asarray(ref)


@pytest.mark.parametrize("variant", ["example", "src", "diffuse_only",
                                     "glossy", "glass"])
def test_render_image_env_sampling_matches_jax(variant):
    scene = {"glossy": jax_glossy_scene,
             "glass": jax_glass_scene}.get(variant, jax_sun_scene)()
    env = jibl.with_env_sampler(jax_sun(front=variant == "glossy"))
    kw = dict(src=dict(roughness_fresnel=False, restart_at_hit=False),
              diffuse_only=dict(diffuse_only=True)).get(variant, {})
    cfg = jax_cfg(env_sampling=True,
                  max_raytrace=6 if variant != "example" else 4)
    got, ref = _render_pair(scene, env, cfg, **kw)
    assert_image_bar(got, ref)
    # NEE changes the estimate: the same render without it differs
    plain, _ = _render_pair(scene, env, cfg.replace(env_sampling=False),
                            **kw)
    assert not np.allclose(plain, got)


def test_specular_density_integrates_to_selection_prob():
    """``tests/test_nee.py:243-282``: over the sphere the joint density
    integrates to the probability that the interaction reflects and is not
    killed, checked against a direct simulation (rel 0.05)."""
    scene = convert.scene_from_jax(jax_glossy_scene(), CPU)
    cfg = convert.config_from_jax(jax_cfg())
    n = 200_000
    rng = np.random.default_rng(0)
    normal = tt(np.tile([[0.0, 1.0, 0.0]], (n, 1)).astype(np.float32))
    d = np.array([0.6, -0.7, 0.2])
    d /= np.linalg.norm(d)
    direction = tt(np.tile(d[None], (n, 1)).astype(np.float32))
    idx = torch.ones((n,), dtype=torch.int32)
    outer = torch.ones((n,), dtype=torch.bool)
    z = rng.uniform(-1, 1, n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    r = np.sqrt(np.maximum(1 - z * z, 0))
    w = tt(np.stack([r * np.cos(phi), z, r * np.sin(phi)], -1))
    p = tshade.specular_env_density(scene, idx, direction, normal, outer, w,
                                    cfg, roughness_fresnel=True,
                                    reflect_kill=True)
    integral = float(p.mean()) * 4 * np.pi
    u = trng.uniform4(torch.arange(n), 0, 7, 1)
    pos = tt(np.tile([[0.0, 1.0, 0.0]], (n, 1)).astype(np.float32))
    inter = tshade.ray_surface_interaction(scene, idx, pos, direction, u,
                                           cfg, roughness_fresnel=True,
                                           reflect_kill=True)
    frac = float((inter.reflect & ~inter.killed).float().mean())
    assert integral == pytest.approx(frac, rel=0.05), (integral, frac)
