"""The port's path-replay backward (``ops/replay.py``) on the CPU: every
test of ``tests/test_replay.py`` on the port (the forward bit-exact to the
megakernel, the gradients equal to scan-AD's, the 128-bounce budget, NEE,
the march checkpoint, ``render_pixels``), and the port's replay gradients
equal to the JAX package's.

Scenes, rays and pixel ids are made by the JAX package and converted
(``convert.*_from_jax``), at ``tests/test_replay.py``'s sizes: 96 lanes at
12-16 bounces, 48 at 128.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import camera as jcamera
from raytracingpbr_tpu.ops import ibl as jibl
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.ops.scene import ObjectSpec as JSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.ops import ibl as tibl
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.parallel import train as ptrain

from .torch_helpers import CPU, nn, tt


def _rays(cfg, cam, n, seed):
    rng = np.random.default_rng(seed)
    pid = jnp.asarray(
        rng.choice(cfg.num_pixels, size=n, replace=False).astype(np.uint32))
    u = jrng.uniform4(pid, 0, 1, cfg.seed)
    uv = jcamera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    return pid, jcamera.get_ray(cam, uv, u[2], u[3])


def jax_setup(n=96, max_raytrace=16, seed=1):
    scene = jcornell.full_scene()
    cfg = jcornell.full_config().replace(max_raytrace=max_raytrace)
    cam = jcornell.full_camera()
    pid, rays = _rays(cfg, cam, n, seed)
    return scene, jcornell.sky(), cam, cfg, pid, rays


def jax_nee_setup(n=96, max_raytrace=8, seed=2):
    """``tests/test_replay.py``'s sun-lit open scene with a baked sky."""
    img = np.full((32, 16, 3), 0.05, np.float32)
    img[8:12, 11:15] = 25.0
    env = jibl.with_env_sampler(
        rt.hdr_environment(jnp.asarray(img), prebake=False))
    scene = rt.make_scene([
        JSpec(JSHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
              albedo=(0.7, 0.7, 0.7), roughness=1.0),
        JSpec(JSHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
              albedo=(0.6, 0.4, 0.3), roughness=1.0),
    ])
    cam = rt.make_camera(lookfrom=(0, 1.0, 4.0), lookat=(0, 0, 0),
                         vfov=40.0, aspect=1.0, aperture=0.0, focus=1.0)
    cfg = rt.RenderConfig(
        resolution=(12, 12), max_raymarch=48, max_raytrace=max_raytrace,
        light_quality=16.0, roulette=rt.Roulette.EXP, omega=1.0,
        omega_policy=rt.OmegaPolicy.CONSTANT,
        hit_criterion=rt.HitCriterion.ABSOLUTE, hit_precision=1e-4,
        march_t0=0.005, max_dis=300.0, env_sampling=True)
    pid, rays = _rays(cfg, cam, n, seed)
    return scene, env, cam, cfg, pid, rays


def port(js, jenv, jcfg, jpid, jrays):
    """The JAX setup converted to the port's CPU tensors."""
    return (convert.scene_from_jax(js, CPU),
            convert.environment_from_jax(jenv, CPU),
            convert.config_from_jax(jcfg),
            torch.as_tensor(np.asarray(jpid).astype(np.int64)),
            convert.rays_from_jax(jrays, CPU))


def setup(**kw):
    js, jenv, _, jcfg, jpid, jrays = jax_setup(**kw)
    return port(js, jenv, jcfg, jpid, jrays)


def nee_setup(**kw):
    js, jenv, _, jcfg, jpid, jrays = jax_nee_setup(**kw)
    return port(js, jenv, jcfg, jpid, jrays)


def scene_grads(scene, loss, fields=tscene._BUFFERS):
    """``{field: d loss / d field}`` of ``loss(scene)``, None where the
    loss does not reach it."""
    leaves = [v.clone().requires_grad_(True) for v in tscene.params(scene)]
    grads = torch.autograd.grad(loss(tscene.with_params(scene, leaves)),
                                leaves, allow_unused=True)
    out = dict(zip(tscene.param_names(scene), grads))
    return {k: out[k] for k in fields}


def assert_grads_close(b, a, rtol, atol_rel):
    a = nn(a).astype(np.float64) if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float64)
    b = nn(b).astype(np.float64)
    assert np.abs(a).max() > 0  # the test must exercise a real gradient
    np.testing.assert_allclose(b, a, rtol=rtol,
                               atol=atol_rel * np.abs(a).max())


@pytest.mark.parametrize("reflect_kill", [False, True])
def test_replay_forward_bit_exact(reflect_kill):
    """The replay forward equals ``megakernel_trace`` bit for bit (the
    same counters and f32 order): what the backward's replay rests on."""
    scene, env, cfg, pid, rays = setup()
    ref = tinteg.megakernel_trace(scene, env, rays, pid, 0, cfg,
                                  differentiable=False,
                                  reflect_kill=reflect_kill)
    got = tinteg.megakernel_trace(scene, env, rays, pid, 0, cfg,
                                  differentiable="replay",
                                  reflect_kill=reflect_kill)
    assert torch.equal(got.color, ref.color)


@pytest.mark.parametrize("field", ["albedo", "emission"])
def test_replay_grads_match_scan_ad(field):
    """Replay and scan-AD compute the same estimator for the throughput
    factors: their gradients agree to f32 accumulation."""
    scene, env, cfg, pid, rays = setup(max_raytrace=12)
    w = torch.ones((pid.shape[0], 3)) / pid.shape[0]

    def loss(mode):
        return lambda sc: torch.sum(tinteg.megakernel_trace(
            sc, env, rays, pid, 0, cfg, differentiable=mode).color * w)
    a = scene_grads(scene, loss(True))[field]
    b = scene_grads(scene, loss("replay"))[field]
    assert_grads_close(b, a, 2e-4, 2e-6)


def env_grads(scene, env, rays, pid, cfg, mode, fields, **kw):
    tensors = {k: getattr(env, k).clone().requires_grad_(True)
               for k in fields}
    out = tinteg.megakernel_trace(scene, env.replace(**tensors), rays, pid,
                                  0, cfg, differentiable=mode, **kw)
    return dict(zip(fields, torch.autograd.grad(
        torch.mean(out.color), list(tensors.values()))))


def test_replay_env_scale_grad_matches_scan_ad():
    scene, _, cfg, pid, rays = setup(max_raytrace=12)
    env = tibl.constant_sky((0.4, 0.5, 0.6), device=CPU)
    a = env_grads(scene, env, rays, pid, cfg, True, ("color_a", "scale"))
    b = env_grads(scene, env, rays, pid, cfg, "replay", ("color_a", "scale"))
    assert float(a["color_a"].abs().max()) > 0
    np.testing.assert_allclose(nn(b["color_a"]), nn(a["color_a"]), rtol=2e-4)
    np.testing.assert_allclose(float(b["scale"]), float(a["scale"]),
                               rtol=2e-4)


def test_replay_deep_bounce_reference_budget():
    """The reference's Cornell budget, 128 bounces, on 48 lanes, against
    scan-AD."""
    scene, env, cfg, pid, rays = setup(n=48, max_raytrace=128)

    def loss(mode):
        return lambda sc: torch.mean(tinteg.megakernel_trace(
            sc, env, rays, pid, 0, cfg, differentiable=mode).color)
    b = scene_grads(scene, loss("replay"), ("albedo",))["albedo"]
    a = scene_grads(scene, loss(True), ("albedo",))["albedo"]
    assert torch.isfinite(b).all()
    assert_grads_close(b, a, 5e-4, 1e-6)


def test_replay_env_sampling_forward_bit_exact():
    """With NEE on, the replay forward (the path product plus the banked
    radiance) equals ``megakernel_trace`` bit for bit."""
    scene, env, cfg, pid, rays = nee_setup()
    ref = tinteg.megakernel_trace(scene, env, rays, pid, 0, cfg,
                                  differentiable=False, reflect_kill=False)
    got = tinteg.megakernel_trace(scene, env, rays, pid, 0, cfg,
                                  differentiable="replay")
    assert torch.equal(got.color, ref.color)


@pytest.mark.parametrize("field", ["albedo", "emission"])
def test_replay_env_sampling_grads_match_scan_ad(field):
    """The bank factors' VJPs and the suffix cotangents reproduce scan-AD
    on the materials."""
    scene, env, cfg, pid, rays = nee_setup(max_raytrace=6)
    w = torch.ones((pid.shape[0], 3)) / pid.shape[0]

    def loss(mode):
        return lambda sc: torch.sum(tinteg.megakernel_trace(
            sc, env, rays, pid, 0, cfg, differentiable=mode,
            reflect_kill=False).color * w)
    a = scene_grads(scene, loss(True))[field]
    b = scene_grads(scene, loss("replay"))[field]
    assert_grads_close(b, a, 5e-4, 5e-6)


def test_replay_env_sampling_env_image_grad_matches_scan_ad():
    """The HDR image's gradient through the sky lookups and the bank's
    importance-sampled fetch."""
    scene, env, cfg, pid, rays = nee_setup(max_raytrace=6)
    a = env_grads(scene, env, rays, pid, cfg, True, ("image",),
                  reflect_kill=False)["image"]
    b = env_grads(scene, env, rays, pid, cfg, "replay", ("image",),
                  reflect_kill=False)["image"]
    assert_grads_close(b, a, 5e-4, 5e-6)


@pytest.mark.parametrize("env_sampling", [False, True])
def test_replay_march_checkpoint_bit_identical(env_sampling):
    """``cfg.replay_march_checkpoint`` on and off: the forward values are
    bit-identical, the gradients equal to f32 reassociation."""
    if env_sampling:
        scene, env, cfg, pid, rays = nee_setup(max_raytrace=6)
    else:
        scene, env, cfg, pid, rays = setup(max_raytrace=12)

    def run_with(flag):
        c = cfg.replace(replay_march_checkpoint=flag)
        leaves = [v.clone().requires_grad_(True)
                  for v in tscene.params(scene)]
        v = torch.mean(tinteg.megakernel_trace(
            tscene.with_params(scene, leaves), env, rays, pid, 0, c,
            differentiable="replay").color)
        return v, torch.autograd.grad(v, leaves, allow_unused=True)

    (v_on, g_on), (v_off, g_off) = run_with(True), run_with(False)
    assert torch.equal(v_on, v_off)
    for a, b in zip(g_on, g_off):
        a, b = nn(a), nn(b)
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-7 * (np.abs(a).max() + 1e-30))


def test_replay_through_render_pixels():
    """``render_pixels`` takes the replay mode."""
    js, jenv, jcam, jcfg, jpid, _ = jax_setup(n=64, max_raytrace=32)
    scene, env, cfg, pid, _ = port(js, jenv, jcfg, jpid, _rays(
        jcfg, jcam, 64, 1)[1])
    cam = convert.camera_from_jax(jcam, CPU)
    g = scene_grads(scene, lambda sc: torch.mean(ptrain.render_pixels(
        sc, env, cam, pid, cfg, spp=1, differentiable="replay")),
        ("albedo",))["albedo"]
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("case", ["cornell", "nee"])
def test_replay_grads_match_jax_replay(case):
    """The port's replay gradients (albedo, emission; the sky image under
    NEE) equal the JAX package's replay gradients at rtol 2e-4."""
    if case == "nee":
        js, jenv, _, jcfg, jpid, jrays = jax_nee_setup(max_raytrace=6)
    else:
        js, jenv, _, jcfg, jpid, jrays = jax_setup(max_raytrace=12)
    n = int(jpid.shape[0])
    w = np.random.default_rng(3).uniform(0.5, 1.5, (n, 3)).astype(np.float32)

    def jloss(sc, img):
        out = jinteg.megakernel_trace(sc, jenv.replace(image=img), jrays,
                                      jpid, 0, jcfg, differentiable="replay")
        return jnp.sum(out.color * w) / n
    j_scene, j_image = jax.grad(jloss, argnums=(0, 1))(js, jenv.image)

    scene, env, cfg, pid, rays = port(js, jenv, jcfg, jpid, jrays)
    leaves = [v.clone().requires_grad_(True) for v in tscene.params(scene)]
    extra = {}
    if case == "nee":
        extra["image"] = env.image.clone().requires_grad_(True)
    out = tinteg.megakernel_trace(tscene.with_params(scene, leaves),
                                  env.replace(**extra), rays, pid, 0, cfg,
                                  differentiable="replay")
    grads = torch.autograd.grad(torch.sum(out.color * tt(w)) / n,
                                leaves + list(extra.values()),
                                allow_unused=True)
    got = dict(zip(tscene.param_names(scene), grads))
    for field in ("albedo", "emission"):
        assert_grads_close(got[field], getattr(j_scene, field), 2e-4, 2e-6)
    if case == "nee":
        assert_grads_close(grads[-1], j_image, 2e-4, 2e-6)
