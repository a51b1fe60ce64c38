"""The wavefront's options against JAX: adaptive sampling (the per-pixel
active gate), the low-discrepancy camera sampler, the black background and
the unsplit march (a budget that ``march_split`` does not divide), from the
same converted mid-flight state. Lane agreement at rtol 1e-4, as in
``test_torch_slice.py``."""
import jax
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.config import RenderConfig, Roulette
from raytracingpbr_tpu_torch.core.types import make_frame_state, refresh
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import integrator as tinteg

from .torch_helpers import CPU, nn

JCFG = jcornell.full_config().replace(
    resolution=(16, 16), max_raymarch=48, max_raytrace=12,
    samples_per_frame=3, adaptive_sampling=True, noise_threshold=0.34,
    low_discrepancy=True, black_background=True)


@pytest.fixture(scope="module")
def jax_frames():
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st,
                                                   JCFG))
    state = j_make_state(JCFG.num_pixels)
    out = []
    for _ in range(3):  # after two frames the noise metric splits pixels
        px, state = frame(state)
        out.append((px, state))
    return out


def _lanes_close(a, b, rtol=1e-4, atol=1e-6):
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def test_options_match_jax(jax_frames):
    (_, _), (_, mid), (j_px, j_next) = jax_frames
    gate = np.asarray(mid.noise) > JCFG.noise_threshold
    assert 0 < gate.mean() < 1  # the gate is doing something
    t_px, t_next = tinteg.render_frame(
        tcornell.full_scene(CPU), tcornell.sky(CPU), tcornell.full_camera(CPU),
        convert.frame_state_from_jax(mid, CPU), convert.config_from_jax(JCFG))
    got = convert.frame_state_to_numpy(t_next)
    assert got["frame"] == int(np.asarray(j_next.frame))
    np.testing.assert_array_equal(got["respawn"], np.asarray(j_next.respawn))
    ref = {"rays.origin": j_next.rays.origin, "rays.color": j_next.rays.color,
           "rays.depth": j_next.rays.depth, "accum": j_next.accum,
           "hit_t": j_next.hit_t, "noise": j_next.noise,
           "diff_accum": j_next.diff_accum}
    for k, v in ref.items():
        frac = _lanes_close(got[k], np.asarray(v)).mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"
    assert _lanes_close(nn(t_px), np.asarray(j_px)).mean() >= 0.99
    # gated-off pixels are untouched
    before = convert.frame_state_to_numpy(
        convert.frame_state_from_jax(mid, CPU))
    for k in ("accum", "rays.origin", "respawn"):
        np.testing.assert_array_equal(got[k][~gate], before[k][~gate])


def test_refresh_rearms_and_keeps_frame():
    cfg = tcornell.full_config().replace(resolution=(8, 8), max_raymarch=64,
                                         max_raytrace=8, samples_per_frame=2,
                                         march_split=16)
    scene, env, cam = (tcornell.full_scene(CPU), tcornell.sky(CPU),
                       tcornell.full_camera(CPU))
    _, st = tinteg.render_frame(scene, env, cam, make_frame_state(64, CPU),
                                cfg)
    assert float(st.accum[:, 3].sum()) > 0
    r = refresh(st)
    assert float(r.accum.abs().sum()) == 0 and int(r.frame) == 1
    assert int(r.march_cum.abs().sum()) == 0
    assert int(r.rays.depth.abs().sum()) == 0
    _, st2 = tinteg.render_frame(scene, env, cam, st, cfg, refreshing=True)
    assert int(st2.frame) == 2
    assert float(st2.accum[:, 3].max()) <= cfg.samples_per_frame


@pytest.mark.parametrize("field", ["reprojection"])
def test_unported_options_raise(field):
    """The option, once unported (it raised), now runs: with no
    ``prev_cam`` a frame renders exactly as without it, refreshing or
    not, as JAX's ``render_frame`` does."""
    cfg = RenderConfig(resolution=(4, 4), max_raymarch=64, max_raytrace=8)
    args = (tcornell.full_scene(CPU), tcornell.sky(CPU),
            tcornell.full_camera(CPU))
    for refreshing in (False, True):
        ref = tinteg.render_frame(*args, make_frame_state(16, CPU), cfg,
                                  refreshing=refreshing)
        got = tinteg.render_frame(*args, make_frame_state(16, CPU),
                                  cfg.replace(**{field: True}),
                                  refreshing=refreshing)
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1].accum, ref[1].accum)
        assert torch.equal(got[1].hit_t, ref[1].hit_t)


def test_env_sampling_requires_baked_table():
    """JAX's error: ``cfg.env_sampling`` with an environment that has no
    baked alias table raises ValueError (on the first step that banks)."""
    from .test_torch_nee_stats import CAM, base_cfg, sun_env, sun_scene
    cfg = base_cfg(env_sampling=True, roulette=Roulette.DEPTH_LINEAR)
    with pytest.raises(ValueError, match="alias"):
        tinteg.render_image_progressive(sun_scene(), sun_env(), CAM, cfg,
                                        spp=1, max_frames=1)
