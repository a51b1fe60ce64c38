"""Render-level gradients of the port on the CPU: ``tests/test_gradients.py``'s
finite-difference checks on the port's ``render_pixels`` (scan-AD), the
float64 oracle at 1e-3 relative included, and the port's gradients equal
to JAX's ``jax.grad`` on the same scene, per parameter class, and through
one wavefront step.

The counter RNG freezes the sample paths, so finite differences and
autograd differentiate the same deterministic function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.ops.scene import ObjectSpec as JSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu.parallel import train as jtrain
import raytracingpbr_tpu_torch as tr
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.ops import ibl as tibl
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops.scene import ObjectSpec
from raytracingpbr_tpu_torch.ops.sdf import SHAPE
from raytracingpbr_tpu_torch.parallel import train as ptrain

from .torch_helpers import CPU, nn, tt

F64 = torch.float64


def base_cfg(**kw):
    d = dict(resolution=(12, 12), max_raymarch=48, max_raytrace=4,
             light_quality=1e9, roulette=tr.Roulette.EXP,
             omega=1.0, omega_policy=tr.OmegaPolicy.CONSTANT,
             hit_criterion=tr.HitCriterion.ABSOLUTE, hit_precision=1e-4,
             march_t0=0.005, max_dis=100.0)
    d.update(kw)
    return tr.RenderConfig(**d)


def camera(dtype=torch.float32):
    return tr.make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          vfov=40.0, aspect=1.0, aperture=0.0, focus=1.0,
                          device=CPU, dtype=dtype)


CAM = camera()


def sphere_scene(albedo=(0.5, 0.5, 0.5), emission=(1.0, 1.0, 1.0),
                 roughness=1.0, radius=1.0, dtype=torch.float32):
    return tr.make_scene([ObjectSpec(
        SHAPE.SPHERE, position=(0, 0, 0), scale=(radius,) * 3,
        albedo=albedo, emission=emission, roughness=roughness)],
        device=CPU, dtype=dtype)


def render_mean(scene, env, cfg, cam=CAM, spp=2):
    pid = torch.arange(cfg.num_pixels)
    return torch.mean(ptrain.render_pixels(scene, env, cam, pid, cfg,
                                           spp=spp))


def set_at(v, index, x):
    """``v`` with ``v[index]`` replaced by the 0-d tensor ``x`` (out of
    place, so the result is differentiable in ``x``)."""
    out = v.clone()
    out[index] = x
    return out


def check_fd(f, x0, eps, rel=5e-2, abs_tol=1e-4, dtype=torch.float32):
    """d f/dx at x0 by autograd against central finite differences. An
    output that autograd finds independent of ``x`` has gradient 0 (under
    a white sky the image is piecewise constant in the geometry)."""
    x = torch.tensor(x0, dtype=dtype, requires_grad=True)
    y = f(x)
    g = torch.autograd.grad(y, x)[0] if y.requires_grad else 0.0
    with torch.no_grad():
        fd = (float(f(torch.tensor(x0 + eps, dtype=dtype)))
              - float(f(torch.tensor(x0 - eps, dtype=dtype)))) / (2 * eps)
    g = float(g)
    assert np.isfinite(g) and np.isfinite(fd)
    assert g == pytest.approx(fd, rel=rel, abs=abs_tol), (g, fd)
    return g, fd


class TestMaterialGradients:
    def test_albedo(self):
        cfg, env = base_cfg(), tr.white_sky(device=CPU)
        s = sphere_scene()
        g, _ = check_fd(lambda a: render_mean(
            s.replace(albedo=set_at(s.albedo, (0, 0), a)), env, cfg),
            0.5, 1e-3, rel=1e-2)
        assert g > 0

    def test_emission(self):
        cfg, env = base_cfg(), tr.black_sky(device=CPU)
        s = sphere_scene()
        g, _ = check_fd(lambda e: render_mean(
            s.replace(emission=e * torch.ones((1, 3))), env, cfg),
            2.0, 1e-3, rel=1e-2)
        assert g > 0

    def test_roughness(self):
        cfg = base_cfg()
        env = tibl.hdr_environment(np.random.default_rng(0).uniform(
            0.1, 2.0, (16, 8, 3)).astype(np.float32), prebake=False,
            device=CPU)
        s = sphere_scene(roughness=0.5)
        check_fd(lambda r: render_mean(s.replace(roughness=r.reshape(1)),
                                       env, cfg),
                 0.5, 1e-3, rel=0.1, abs_tol=1e-3)


class TestShapeGradients:
    def test_sphere_radius(self):
        """The SDF's shape through the implicit hit-point VJP."""
        cfg, env = base_cfg(), tr.white_sky(device=CPU)
        s = sphere_scene()
        check_fd(lambda r: render_mean(s.replace(scale=r * torch.ones(
            (1, 3))), env, cfg), 1.0, 1e-3, rel=0.15, abs_tol=2e-3)

    def test_object_position(self):
        cfg, env = base_cfg(), tr.white_sky(device=CPU)
        s = sphere_scene()
        check_fd(lambda z: render_mean(
            s.replace(position=set_at(s.position, (0, 2), z)), env, cfg),
            0.0, 1e-3, rel=0.15, abs_tol=2e-3)


class TestEnvmapGradients:
    def test_envmap_texel(self):
        cfg = base_cfg()
        img0 = torch.full((16, 8, 3), 0.5)

        def f(v):
            img = torch.cat([torch.zeros_like(img0[..., :1]) + v,
                             img0[..., 1:]], -1)
            env = tibl.hdr_environment(img, prebake=False)
            return render_mean(sphere_scene(), env, cfg)
        g, _ = check_fd(f, 0.5, 1e-3, rel=1e-2)
        assert g > 0


class TestCameraGradients:
    def test_lookfrom(self):
        cfg, env = base_cfg(), tr.white_sky(device=CPU)
        scene = sphere_scene(albedo=(0.3, 0.3, 0.3))

        def f(z):
            cam = camera()
            cam.lookfrom = set_at(cam.lookfrom, 2, z)
            return render_mean(scene, env, cfg, cam=cam)
        check_fd(f, 3.0, 1e-3, rel=0.2, abs_tol=2e-3)


class TestF64Oracle:
    """``tests/test_gradients.py``'s bar verbatim: finite differences and
    autograd agree at 1e-3 relative for every parameter class, the render
    in float64 on the CPU (camera, scene and environment in f64; the march
    and the shading follow the data) under a smooth bilinear HDR sky."""

    @staticmethod
    def _env_img():
        rng = np.random.default_rng(0)
        base = rng.uniform(0.2, 1.5, (8, 4, 3))
        return np.kron(base, np.ones((4, 4, 1)))  # smooth 32x16

    def _check(self, make_f, x0, eps=1e-5, rel=1e-3):
        cfg = base_cfg(max_raymarch=64, hit_precision=1e-7)
        env = tibl.hdr_environment(self._env_img(), prebake=False,
                                   bilinear=True, device=CPU, dtype=F64)

        def scene64():
            return tr.make_scene([ObjectSpec(
                SHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
                albedo=(0.5, 0.5, 0.5), emission=(1.0, 1.0, 1.0),
                roughness=0.5)], device=CPU, dtype=F64)

        def mean_img(s, cam=None, e=env):
            return render_mean(s, e, cfg, cam=cam or camera(F64))

        f = make_f(scene64, mean_img)
        check_fd(f, x0, eps, rel=rel, abs_tol=1e-9, dtype=F64)

    def test_albedo(self):
        self._check(lambda sc, m: lambda a: m(sc().replace(
            albedo=a * torch.ones((1, 3), dtype=F64))), 0.5)

    def test_emission(self):
        self._check(lambda sc, m: lambda e: m(sc().replace(
            emission=e * torch.ones((1, 3), dtype=F64))), 2.0)

    def test_roughness(self):
        self._check(lambda sc, m: lambda r: m(sc().replace(
            roughness=r.reshape(1))), 0.5)

    def test_sphere_radius(self):
        self._check(lambda sc, m: lambda r: m(sc().replace(
            scale=r * torch.ones((1, 3), dtype=F64))), 1.0)

    def test_object_position(self):
        self._check(lambda sc, m: lambda z: m(sc().replace(
            position=set_at(torch.zeros((1, 3), dtype=F64), (0, 2), z))),
            0.0)

    def test_envmap(self):
        img = torch.as_tensor(self._env_img(), dtype=F64)
        self._check(lambda sc, m: lambda v: m(sc(), e=tibl.hdr_environment(
            img * v, prebake=False, bilinear=True)), 1.0)

    def test_camera_lookfrom(self):
        def make(sc, m):
            def f(z):
                cam = camera(F64)
                cam.lookfrom = set_at(cam.lookfrom, 2, z)
                return m(sc(), cam=cam)
            return f
        self._check(make, 3.0)


# --- the port against JAX ---------------------------------------------------

JCFG = rt.RenderConfig(
    resolution=(12, 12), max_raymarch=64, max_raytrace=4, light_quality=1e9,
    roulette=rt.Roulette.EXP, omega=1.0,
    omega_policy=rt.OmegaPolicy.CONSTANT,
    hit_criterion=rt.HitCriterion.ABSOLUTE, hit_precision=1e-4,
    march_t0=0.005, max_dis=100.0)
SCENE_FIELDS = ("albedo", "emission", "roughness", "scale", "position",
                "matrix")


def _jax_setup():
    """A rough sphere on a turned box under a smooth HDR sky: every
    parameter class takes a real gradient."""
    scene = rt.make_scene([
        JSpec(JSHAPE.SPHERE, (0.0, 0.2, 0.0), (0, 0, 0), (0.7,) * 3,
              albedo=(0.6, 0.5, 0.4), roughness=0.5, metallic=0.2),
        JSpec(JSHAPE.BOX, (0.0, -0.9, 0.0), (10, 25, 5), (1.2, 0.2, 1.0),
              albedo=(0.3, 0.6, 0.5), roughness=0.8)])
    rng = np.random.default_rng(0)
    img = np.kron(rng.uniform(0.2, 1.5, (8, 4, 3)),
                  np.ones((4, 4, 1))).astype(np.float32)
    env = rt.hdr_environment(jnp.asarray(img), prebake=False, bilinear=True)
    cam = rt.make_camera(lookfrom=(0.3, 0.4, 3.0), lookat=(0.0, 0.0, 0.0),
                         vfov=40.0, aspect=1.0, aperture=0.0, focus=1.0)
    return scene, env, cam


@pytest.fixture(scope="module")
def render_pixels_grads(request):
    """JAX's ``jax.grad`` of a weighted pixel sum through its
    ``render_pixels`` (scan-AD) in the scene, the environment image and
    scale and the camera, and the port's autograd of the same."""
    scene, env, cam = _jax_setup()
    pid = np.arange(JCFG.num_pixels, dtype=np.uint32)
    w = np.random.default_rng(1).uniform(0.5, 1.5, (pid.size, 3)).astype(
        np.float32)

    def jloss(sc, en, cm):
        img = jtrain.render_pixels(sc, en, cm, jnp.asarray(pid), JCFG, spp=2)
        return jnp.sum(img * w) / pid.size
    j_img = jtrain.render_pixels(scene, env, cam, jnp.asarray(pid), JCFG,
                                 spp=2)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(scene, env, cam)

    ts = convert.scene_from_jax(scene, CPU)
    leaves = [v.clone().requires_grad_(True) for v in tscene.params(ts)]
    tenv = convert.environment_from_jax(env, CPU)
    img = tenv.image.clone().requires_grad_(True)
    scale = tenv.scale.clone().requires_grad_(True)
    tcam = convert.camera_from_jax(cam, CPU)
    tcam.lookfrom = tcam.lookfrom.clone().requires_grad_(True)
    t_img = ptrain.render_pixels(
        tscene.with_params(ts, leaves), tenv.replace(image=img, scale=scale),
        tcam, torch.arange(pid.size), convert.config_from_jax(JCFG), spp=2)
    loss = torch.sum(t_img * tt(w)) / pid.size
    grads = torch.autograd.grad(loss, leaves + [img, scale, tcam.lookfrom],
                                allow_unused=True)
    port = dict(zip(tscene._BUFFERS, grads))
    port.update(env_image=grads[-3], env_scale=grads[-2],
                lookfrom=grads[-1])
    ref = {k: getattr(jg[0], k) for k in tscene._BUFFERS}
    ref.update(env_image=jg[1].image, env_scale=jg[1].scale,
               lookfrom=jg[2].lookfrom)
    return port, ref, nn(t_img), np.asarray(j_img)


@pytest.mark.parametrize("field", SCENE_FIELDS + ("env_image", "env_scale",
                                                  "lookfrom"))
def test_render_pixels_grad_matches_jax(render_pixels_grads, field):
    """Per parameter class, the port's scan-AD gradient equals JAX's at
    rtol 1e-4 (an absolute floor of 1e-5 of the largest entry); the
    images agree first."""
    port, ref, t_img, j_img = render_pixels_grads
    np.testing.assert_allclose(t_img, j_img, rtol=1e-4, atol=1e-6)
    want = np.asarray(ref[field], np.float64)
    assert np.abs(want).max() > 0, field  # a real gradient
    got = nn(port[field]).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("split", [None, 16])
def test_wavefront_step_albedo_grad_matches_jax(split):
    """One ``wavefront_step(differentiable=True)`` from a mid-flight state
    of the Cornell box (three forward frames in JAX, converted): the
    ``albedo`` gradient of a weighted sum of the new rays' colours and the
    accumulator equals JAX's, with the march unsplit and split (``_hit_t``
    on the lanes whose segment completed)."""
    jcfg = jcornell.full_config().replace(
        resolution=(12, 12), max_raymarch=48, max_raytrace=12,
        samples_per_frame=1, march_split=split)
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    state = j_make_state(jcfg.num_pixels)
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st,
                                                   jcfg))
    for _ in range(3):
        _, state = frame(state)
    n = jcfg.num_pixels
    rng = np.random.default_rng(2)
    w_c = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    w_a = rng.uniform(0.5, 1.5, (n, 4)).astype(np.float32)
    pid = jnp.arange(n, dtype=jnp.uint32)
    kw = dict(march_state=state.march_state, march_cum=state.march_cum,
              respawn=state.respawn)

    def jloss(albedo):
        out = jinteg.wavefront_step(
            scene.replace(albedo=albedo), env, cam, state.rays, state.accum,
            pid, jnp.uint32(3), jcfg, differentiable=True, **kw)
        return jnp.sum(out[0].color * w_c) + jnp.sum(out[1] * w_a)
    want = np.asarray(jax.grad(jloss)(scene.albedo))

    ts = convert.frame_state_from_jax(state, CPU)
    tscn = convert.scene_from_jax(scene, CPU)
    albedo = tscn.albedo.clone().requires_grad_(True)
    out = tinteg.wavefront_step(
        tscn.replace(albedo=albedo), convert.environment_from_jax(env, CPU),
        convert.camera_from_jax(cam, CPU), ts.rays, ts.accum,
        torch.arange(n), 3, convert.config_from_jax(jcfg),
        differentiable=True, march_state=ts.march_state,
        march_cum=ts.march_cum, respawn=ts.respawn)
    loss = torch.sum(out[0].color * tt(w_c)) + torch.sum(out[1] * tt(w_a))
    (got,) = torch.autograd.grad(loss, albedo)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(nn(got), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
