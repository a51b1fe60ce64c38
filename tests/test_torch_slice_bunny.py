"""The second slice end to end: the neural-bunny glass wavefront frame and
the demo scenes' golden.

* one bunny-glass ``render_frame`` (animated to frame 12, HDR sky) from the
  same converted mid-flight ``FrameState`` agrees with JAX: counters
  exact, at least 99% of lanes within rtol 1e-4 (the port marches the MLP
  in the kernel's order and XLA with dots, so a grazing lane may flip);
* the ``wavefront_scene_demo`` golden (``tests/golden_specs.py``) scores
  at least 35 dB: ROLLBACK_TO_ONE with the RELATIVE hit test, K1b's
  variant, through the progressive integrator.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.io.image import read_png
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.models import demo as tdemo
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.utils.metrics import psnr

from .test_torch_slice import _jax_leaves, _lanes_close
from .torch_helpers import CPU, nn

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "assets", "goldens",
                      "wavefront_scene_demo.png")

JCFG = jbunny.glass_config().replace(
    resolution=(24, 14), max_raymarch=128, max_raytrace=8,
    samples_per_frame=4, samples_per_pixel=1)


@pytest.fixture(scope="module")
def jax_frames():
    """Two JAX wavefront frames of the animated glass bunny: ``[(pixels,
    state), ...]`` (the file's one JAX frame compilation)."""
    scene = jbunny.animated_scene(jbunny.glass_scene(), jnp.asarray(12.0))
    env = jbunny.glass_environment()
    cam = jbunny.camera(JCFG.width / JCFG.height)
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st,
                                                   JCFG))
    state = j_make_state(JCFG.num_pixels)
    out = []
    for _ in range(2):
        px, state = frame(state)
        out.append((px, state))
    return out


def test_bunny_render_frame_matches_jax_from_converted_state(jax_frames):
    (_, mid), (j_px, j_next) = jax_frames
    assert int(np.asarray(mid.march_cum).max()) > 0  # segments in flight
    scene = tbunny.animated_scene(tbunny.glass_scene(CPU), 12.0)
    t_px, t_next = tinteg.render_frame(
        scene, tbunny.glass_environment(device=CPU),
        tbunny.camera(JCFG.width / JCFG.height, CPU),
        convert.frame_state_from_jax(mid, CPU), convert.config_from_jax(JCFG))
    got = convert.frame_state_to_numpy(t_next)
    ref = _jax_leaves(j_next)
    assert got["frame"] == ref["frame"]
    np.testing.assert_array_equal(got["respawn"], ref["respawn"])
    for k in ("rays.origin", "rays.direction", "rays.color", "rays.depth",
              "accum", "march_state", "march_cum", "hit_t"):
        frac = _lanes_close(got[k], ref[k]).mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"
    frac = _lanes_close(nn(t_px), np.asarray(j_px)).mean()
    assert frac >= 0.99, f"pixels: only {frac:.2%} of lanes agree"
    # the frame saw the bunny: some paths refracted through the glass
    assert (ref["rays.depth"] > 1).any()


def test_wavefront_scene_demo_golden():
    """The ``scene_demo`` spec of ``tests/golden_specs.py`` through the
    wavefront integrator."""
    cfg = tdemo.scene_demo_config().replace(resolution=(64, 36),
                                            max_raymarch=128,
                                            max_raytrace=8)
    img, state = tinteg.render_image_progressive(
        tdemo.scene_demo_scene(CPU), tdemo.gradient_environment(device=CPU),
        tdemo.engine_camera(CPU), cfg, spp=6, exposure=1.0)
    assert float(state.accum[:, 3].min()) >= 6
    gold = read_png(GOLDEN)[..., :3]
    got = (np.clip(nn(img), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert got.shape == gold.shape
    db = psnr(got, gold)
    assert db >= 35.0, f"PSNR {db:.2f} dB"
