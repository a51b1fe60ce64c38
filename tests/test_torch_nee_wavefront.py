"""NEE through the port's wavefront integrator, on the CPU:

* one frame of ``wavefront_step``s with ``cfg.env_sampling`` from a
  converted mid-flight JAX state (``sky_w`` and the split-march carry
  included) against JAX's frame, at ``test_torch_wavefront.py``'s lane bar
  (rtol 1e-4 on at least 99% of lanes), with the march unsplit and split.
  The ground is a box here: deep inside ``tests/test_nee.py``'s radius-100
  ground sphere ``|p - c| - 100`` cancels in f32 and the two frameworks'
  last-ulp drift moves hit points by 1e-4 (ROADMAP Queue 3). Ray origins
  and directions are compared on live lanes: an escaped lane's origin is
  its march's last point, hundreds of units out, unused.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.ops import ibl as jibl
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.ops.scene import ObjectSpec as JObjectSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.ops import integrator as tinteg

from .test_torch_nee import JCAM, jax_cfg, jax_sun
from .test_torch_wavefront import _lanes_close
from .torch_helpers import CPU, nn


def box_ground_scene(glossy: bool):
    """The sun-lit (or glossy) sphere on a box floor."""
    metal = dict(metallic=1.0) if glossy else {}
    return rt.make_scene([
        JObjectSpec(JSHAPE.BOX, position=(0, -2, 0), scale=(6.0, 1.0, 6.0),
                    albedo=(0.7, 0.7, 0.7),
                    roughness=0.8 if glossy else 1.0, **metal),
        JObjectSpec(JSHAPE.SPHERE, position=(0, 0, 0), scale=(1.0,) * 3,
                    albedo=(0.6, 0.4, 0.3),
                    roughness=0.5 if glossy else 1.0, **metal),
    ])


@pytest.mark.parametrize("name,march", [("sun", "unsplit"),
                                        ("sun", "split"),
                                        ("glossy", "split")])
def test_wavefront_frame_matches_jax(name, march):
    scene = box_ground_scene(name == "glossy")
    env = jibl.with_env_sampler(jax_sun(front=name == "glossy"))
    cfg = jax_cfg(resolution=(16, 16), roulette=rt.Roulette.DEPTH_LINEAR,
                  max_raytrace=16, samples_per_frame=3, env_sampling=True,
                  max_raymarch=48 if march == "unsplit" else 64,
                  march_split=32 if march == "unsplit" else 16)
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, JCAM, st,
                                                   cfg))
    state = j_make_state(cfg.num_pixels)
    for _ in range(2):
        _, state = frame(state)
    j_px, j_next = frame(state)
    t_px, t_next = tinteg.render_frame(
        convert.scene_from_jax(scene, CPU),
        convert.environment_from_jax(env, CPU),
        convert.camera_from_jax(JCAM, CPU),
        convert.frame_state_from_jax(state, CPU),
        convert.config_from_jax(cfg))
    got = convert.frame_state_to_numpy(t_next)
    sky_w = np.asarray(j_next.sky_w)
    assert (sky_w == 1).any()
    if name == "glossy":  # no diffuse lobe: the reflect lobe's MIS weights
        assert ((sky_w > 0) & (sky_w < 1)).any()
    else:  # after a diffuse bounce
        assert (sky_w == 0).any()
    if march == "split":
        assert (np.asarray(state.march_cum) > 0).any()
    ref = {"rays.origin": j_next.rays.origin,
           "rays.direction": j_next.rays.direction,
           "rays.color": j_next.rays.color, "rays.depth": j_next.rays.depth,
           "accum": j_next.accum, "sky_w": j_next.sky_w,
           "march_state": j_next.march_state,
           "march_cum": j_next.march_cum}
    live = np.asarray(j_next.rays.depth) > 0
    assert 0.2 < live.mean() < 1
    for k, v in ref.items():
        ok = _lanes_close(got[k], np.asarray(v))
        frac = ok[live].mean() if k in ("rays.origin",
                                        "rays.direction") else ok.mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"
    assert _lanes_close(nn(t_px), np.asarray(j_px)).mean() >= 0.99


def test_nan_ray_does_not_reach_the_accumulator():
    """A ray whose direction went NaN (the engine frame at 768x432 makes
    one at its fourth step, in both packages) does not bank NEE radiance:
    the JAX package's bank there is 0 * NaN, which its wavefront adds to
    the pixel's accumulator for good (ROADMAP Queue 3); the port's is 0.
    Every other lane is unchanged by the NaN lane."""
    from raytracingpbr_tpu_torch.core.types import make_frame_state
    scene = convert.scene_from_jax(box_ground_scene(False), CPU)
    env = convert.environment_from_jax(jibl.with_env_sampler(jax_sun()), CPU)
    cam = convert.camera_from_jax(JCAM, CPU)
    cfg = convert.config_from_jax(jax_cfg(
        resolution=(8, 8), roulette=rt.Roulette.DEPTH_LINEAR,
        max_raytrace=16, samples_per_frame=2, env_sampling=True))
    _, st = tinteg.render_frame(scene, env, cam,
                                make_frame_state(64, CPU), cfg)
    live = int(np.flatnonzero(nn(st.rays.depth) > 0)[0])
    bad = st.replace(rays=dataclasses.replace(
        st.rays, direction=st.rays.direction.clone()))
    bad.rays.direction[live] = float("nan")
    _, ref = tinteg.render_frame(scene, env, cam, st, cfg)
    _, got = tinteg.render_frame(scene, env, cam, bad, cfg)
    assert bool(torch.isfinite(got.accum).all())
    others = np.arange(64) != live
    np.testing.assert_array_equal(nn(got.accum)[others],
                                  nn(ref.accum)[others])


def test_degenerate_hemisphere_draw_matches_jax():
    """The open fault of ROADMAP Queue 3, at its lane's own inputs (the
    engine frame at 768x432, lane 193,334, fourth step): a first shading
    uniform of exactly 0 on a face whose normal is exactly +z makes
    ``hemispheric``'s sample the negated normal, 0/0, and the mirror
    reflection of this roughness-0 metal box NaN, in both packages alike.
    A second lane with the uniform one step above 0 stays finite. The port
    equals JAX on both lanes, NaN for NaN."""
    from raytracingpbr_tpu.models import demo as jdemo
    from raytracingpbr_tpu.ops import shade as jshade
    from raytracingpbr_tpu_torch.ops import shade as tshade
    h = float.fromhex
    position = np.array([[h("-0x1.563a4p+0"), h("-0x1.fdf77p-2"),
                          h("-0x1.c51a2cp+0")]] * 2, np.float32)
    direction = np.array([[h("-0x1.810354p-2"), h("-0x1.57584p-4"),
                           h("-0x1.d87c7ap-1")]] * 2, np.float32)
    u = [np.array([0.0, 2.0 ** -24], np.float32),
         np.full(2, h("0x1.1dfc8p-6"), np.float32),
         np.full(2, h("0x1.2dc928p-3"), np.float32),
         np.full(2, h("0x1.e4a624p-1"), np.float32)]
    index = np.array([5, 5], np.int32)
    jscene, jcfg = jdemo.engine_scene(), jdemo.engine_config()
    j = jshade.ray_surface_interaction(
        jscene, jax.numpy.asarray(index), jax.numpy.asarray(position),
        jax.numpy.asarray(direction), tuple(map(jax.numpy.asarray, u)),
        jcfg)
    t = tshade.ray_surface_interaction(
        convert.scene_from_jax(jscene, CPU),
        torch.as_tensor(index, dtype=torch.int64),
        torch.as_tensor(position), torch.as_tensor(direction),
        tuple(map(torch.as_tensor, u)), convert.config_from_jax(jcfg))
    np.testing.assert_array_equal(nn(t.direction), np.asarray(j.direction))
    assert np.isnan(np.asarray(j.direction)[0]).all()
    assert np.isfinite(np.asarray(j.direction)[1]).all()
