"""The port's main slice end to end: the Cornell full-PBR wavefront frame.

* one ``render_frame`` from the same converted mid-flight ``FrameState``
  agrees with JAX (the counter RNG makes it a lane-by-lane comparison);
* the ``wavefront_cornell_full`` golden scores >= 35 dB;
* the split march estimates the same image as the unsplit one;
* ``convert`` round-trips a JAX ``FrameState``;
* importing the port, its offline app included, loads neither jax nor
  flax.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.io.image import read_png, write_png
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.utils.metrics import psnr

from .torch_helpers import CPU, nn

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "assets", "goldens", "wavefront_cornell_full.png")


JCFG = jcornell.full_config().replace(
    resolution=(16, 16), max_raymarch=160, max_raytrace=12,
    samples_per_frame=4)


@pytest.fixture(scope="module")
def jax_frames():
    """Two JAX wavefront frames of JCFG: ``[(pixels, state), ...]`` (the
    file's one JAX frame compilation)."""
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st,
                                                   JCFG))
    state = j_make_state(JCFG.num_pixels)
    out = []
    for _ in range(2):
        px, state = frame(state)
        out.append((px, state))
    return out


def _jax_leaves(state) -> dict:
    out = {f"rays.{k}": np.asarray(getattr(state.rays, k))
           for k in ("origin", "direction", "color", "depth")}
    for k in ("accum", "frame", "diff_accum", "noise", "pixels", "respawn",
              "hit_t", "sky_w", "march_state", "march_cum"):
        out[k] = np.asarray(getattr(state, k))
    return out


def _lanes_close(a, b, rtol=1e-4, atol=1e-6):
    """Per-lane agreement of (N, ...) arrays."""
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def test_render_frame_matches_jax_from_converted_state(jax_frames):
    (_, mid), (j_px, j_next) = jax_frames
    assert int(np.asarray(mid.march_cum).max()) > 0  # segments in flight

    t_px, t_next = tinteg.render_frame(
        tcornell.full_scene(CPU), tcornell.sky(CPU), tcornell.full_camera(CPU),
        convert.frame_state_from_jax(mid, CPU), convert.config_from_jax(JCFG))
    got = convert.frame_state_to_numpy(t_next)
    ref = _jax_leaves(j_next)
    # counter-only fields: bit-exact
    assert got["frame"] == ref["frame"]
    np.testing.assert_array_equal(got["respawn"], ref["respawn"])
    # ray state, accumulator and split carry: >= 99% of lanes at rtol 1e-4
    for k in ("rays.origin", "rays.direction", "rays.color", "rays.depth",
              "accum", "march_state", "march_cum", "hit_t"):
        frac = _lanes_close(got[k], ref[k]).mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"
    frac = _lanes_close(nn(t_px), np.asarray(j_px)).mean()
    assert frac >= 0.99, f"pixels: only {frac:.2%} of lanes agree"


def test_convert_round_trips_frame_state(jax_frames):
    state = jax_frames[0][1]
    got = convert.frame_state_to_numpy(
        convert.frame_state_from_jax(state, CPU))
    ref = _jax_leaves(state)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], k)


def test_wavefront_golden():
    """The ``wavefront_cornell_full`` spec of ``tests/golden_specs.py``."""
    cfg = tcornell.full_config().replace(resolution=(64, 64),
                                         max_raymarch=160, max_raytrace=12)
    img, state = tinteg.render_image_progressive(
        tcornell.full_scene(CPU), tcornell.sky(CPU),
        tcornell.full_camera(CPU), cfg,
        spp=8, exposure=0.6)
    assert float(state.accum[:, 3].min()) >= 8
    gold = read_png(GOLDEN)[..., :3]
    got = (np.clip(nn(img), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert got.shape == gold.shape
    db = psnr(got, gold)
    assert db >= 35.0, f"PSNR {db:.2f} dB"


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)


def _accumulate(cfg, frames):
    scene, env, cam = (tcornell.full_scene(CPU), tcornell.sky(CPU),
                       tcornell.full_camera(CPU))
    state = make_frame_state(cfg.num_pixels, CPU)
    for _ in range(frames):
        _, state = tinteg.render_frame(scene, env, cam, state, cfg)
    return nn(state.accum)


def test_split_wavefront_same_estimator():
    """Split and unsplit wavefronts estimate the same image (the property of
    ``tests/test_split_march.py::test_split_wavefront_same_estimator``, at a
    smaller size): per-pixel means agree on average and in the median,
    and the split run deposits at a comparable rate."""
    base = tcornell.full_config().replace(
        resolution=(24, 24), max_raymarch=64, max_raytrace=16,
        samples_per_frame=4, march_split=None)
    a = _accumulate(base, 40)
    b = _accumulate(base.replace(march_split=16), 40)
    assert b[:, 3].sum() > 0.6 * a[:, 3].sum()
    assert b[:, 3].min() > 8
    img_a = a[:, :3] / np.maximum(a[:, 3:4], 1.0)
    img_b = b[:, :3] / np.maximum(b[:, 3:4], 1.0)
    np.testing.assert_allclose(img_b.mean(0), img_a.mean(0), rtol=0.05)
    rel = np.abs(img_b - img_a).max(1) / (img_a.max(1) + 0.05)
    assert np.median(rel) < 0.25, np.median(rel)


def test_import_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import raytracingpbr_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import raytracingpbr_tpu_torch.apps.offline\n"
        "for m in ('apps.offline', 'apps.progressive', 'io.checkpoint',\n"
        "          'utils.validate', 'utils.profiling', 'ops.ibl',\n"
        "          'apps.multihost', 'parallel.scaling', 'ops.reproject',\n"
        "          'convert', 'utils.speedlight', 'bench'):\n"
        "    assert 'raytracingpbr_tpu_torch.' + m in sys.modules, m\n"
        "import chip_smoke, bench_torch\n"
        "import importlib.util as u\n"
        "for t in ('bench_workloads_torch', 'bench_nee_torch',\n"
        "          'bench_adaptive_torch', 'ab_get_ray',\n"
        "          'trace_layers_torch'):\n"
        "    s = u.spec_from_file_location(t, f'tools/{t}.py')\n"
        "    s.loader.exec_module(u.module_from_spec(s))\n"
        "bad = [m for m in ('jax', 'flax', 'raytracingpbr_tpu')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)
