"""Temporal reprojection of the port (``ops/reproject.py``,
``render_frame(prev_cam=...)``): ``tests/test_reproject.py``'s five
properties on the port, and the port against the JAX package on converted
states.

Tolerances against JAX: the pixel-center rays within atol 1e-6, the
projected pixel equal on every center ray; on the same converted state
the warp's targets agree on at least 99.9% of lanes (a point within an
ulp of a pixel edge can floor either way between XLA's and PyTorch's
rounding), the warped accumulator and depths at rtol 1e-5 on at least 99%
of pixels; a frame rendered on the warped state at the wavefront tests'
rtol 1e-4 on at least 99% of lanes. On the CPU the port's ``index_add_``
adds a pixel's sources in lane order, as JAX's scatter does, so the
warped accumulator is bit-equal to JAX's (on at least 99.9% of pixels;
every pixel on these states); the depths differ in the last bits (the
distance's rounding), within rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.ops import reproject as jrp
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.core.types import NO_HIT_T, make_frame_state
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.ops import reproject as rp

from .torch_helpers import CPU, nn, tt

MOVE = np.array([0.02, 0.0, 0.0], np.float32)


def _setup(w=24, h=24, **kw):
    cfg = tcornell.minimal_config().replace(
        resolution=(w, h), max_raytrace=8, reprojection=True, **kw)
    return (tcornell.minimal_scene(CPU), tcornell.sky(CPU),
            tcornell.minimal_camera(CPU), cfg)


def _moved(cam, delta):
    d = torch.as_tensor(delta)
    return cam.__class__(**{**cam.__dict__, "lookfrom": cam.lookfrom + d,
                            "lookat": cam.lookat + d})


def _frames(scene, env, cam, cfg, n, state=None):
    state = state if state is not None else make_frame_state(
        cfg.num_pixels, CPU)
    for _ in range(n):
        _, state = tinteg.render_frame(scene, env, cam, state, cfg)
    return state


@pytest.fixture(scope="module")
def history():
    scene, env, cam, cfg = _setup()
    return scene, env, cam, cfg, _frames(scene, env, cam, cfg, 6)


def test_project_inverts_pixel_center_rays():
    _, _, cam, cfg = _setup()
    ro, rd = rp.pixel_center_rays(cam, cfg)
    flat, valid = rp.project(cam, cfg, ro + 2.5 * rd)
    assert bool(valid.all())
    assert torch.equal(flat, torch.arange(cfg.num_pixels))


def test_hit_t_records_primary_depth(history):
    *_, state = history
    t = nn(state.hit_t)
    # the Cornell box is closed: every primary ray hits something
    assert (t < NO_HIT_T).all()
    assert (t > 0.1).all() and (t < 50.0).all()


def test_identity_reprojection_preserves_history(history):
    scene, env, cam, cfg, state = history
    warped = rp.reproject(state, cam, cam, cfg)
    a0, a1 = nn(state.accum), nn(warped.accum)
    keep = a0[:, 3] > 0
    np.testing.assert_allclose(a1[keep], a0[keep] * cfg.reproject_confidence,
                               rtol=1e-5)
    assert int(warped.rays.depth.abs().sum()) == 0  # re-armed as refresh()
    assert int(warped.frame) == int(state.frame)


def test_small_motion_keeps_most_history(history):
    scene, env, cam, cfg, state = history
    warped = rp.reproject(state, cam, _moved(cam, MOVE), cfg)
    total0 = float(state.accum[:, 3].sum())
    total1 = float(warped.accum[:, 3].sum())
    assert total1 > 0.7 * cfg.reproject_confidence * total0
    assert total1 <= 1.001 * cfg.reproject_confidence * total0


def _mean(state):
    a = nn(state.accum)
    return a[:, :3] / np.maximum(a[:, 3:4], 1.0)


def test_render_frame_reprojection_beats_zero_reset():
    """After a small move, one frame on the reprojected state is closer to
    a converged render of the new view than one frame from scratch."""
    scene, env, cam, cfg = _setup(w=16, h=16)
    cam2 = _moved(cam, [0.01, 0.0, 0.0])
    target = _mean(_frames(scene, env, cam2, cfg, 40))
    hist = _frames(scene, env, cam, cfg, 30)
    _, with_rp = tinteg.render_frame(scene, env, cam2, hist, cfg,
                                     refreshing=True, prev_cam=cam)
    _, from_zero = tinteg.render_frame(scene, env, cam2, hist,
                                       cfg.replace(reprojection=False),
                                       refreshing=True)
    err_rp = np.abs(_mean(with_rp) - target).mean()
    err_zero = np.abs(_mean(from_zero) - target).mean()
    assert err_rp < err_zero, (err_rp, err_zero)


def test_reprojection_without_refresh_or_prev_cam_renders_as_usual(history):
    scene, env, cam, cfg, state = history
    plain = cfg.replace(reprojection=False)
    for kw in (dict(refreshing=False, prev_cam=cam), dict(refreshing=True)):
        ref = tinteg.render_frame(scene, env, cam, state, plain,
                                  refreshing=kw["refreshing"])
        got = tinteg.render_frame(scene, env, cam, state, cfg, **kw)
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1].accum, ref[1].accum)


def test_out_of_frustum_points_are_never_valid():
    """Points behind the camera, far off the frustum (floats far outside
    the int range), on the camera plane, and not finite: none valid, and
    every index a pixel of the frame."""
    _, _, cam, cfg = _setup(w=8, h=6)
    x, y, z = rp.camera_basis(cam)
    eye = cam.lookfrom
    pts = torch.stack([
        eye + z,                        # behind
        eye - 1e-9 * z + x,             # on the camera plane
        eye - z + 1e12 * x,             # u ~ 1e12: past any int32
        eye - z - 1e12 * y,
        eye - 1e-5 * z + 3e4 * x,       # beyond the frustum by ~1e9 pixels
        eye - z + 2.0 * x,              # just off the frustum
        torch.tensor([float("nan"), 0.0, 0.0]),
        torch.tensor([float("inf"), 0.0, -1.0]),
        eye + torch.tensor([float("nan"), float("nan"), float("nan")]),
    ])
    flat, valid = rp.project(cam, cfg, pts)
    assert not bool(valid.any())
    assert bool(((flat >= 0) & (flat < cfg.num_pixels)).all())


# --- against the JAX package -------------------------------------------------


def _jsetup(w=24, h=24):
    cfg = jcornell.minimal_config().replace(
        resolution=(w, h), max_raytrace=8, reprojection=True)
    return (jcornell.minimal_scene(), jcornell.sky(),
            jcornell.minimal_camera(), cfg)


@pytest.fixture(scope="module")
def jax_history():
    scene, env, cam, cfg = _jsetup()
    state = j_make_state(cfg.num_pixels)
    for _ in range(6):
        _, state = jinteg.render_frame(scene, env, cam, state, cfg)
    cam2 = cam.replace(lookfrom=cam.lookfrom + jnp.asarray(MOVE),
                       lookat=cam.lookat + jnp.asarray(MOVE))
    return scene, env, cam, cam2, cfg, state


def _pixels_close(a, b, rtol=1e-5, atol=1e-6):
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def test_center_rays_and_projection_match_jax(jax_history):
    _, _, cam, cam2, jcfg, _ = jax_history
    cfg = convert.config_from_jax(jcfg)
    tcam = convert.camera_from_jax(cam2, CPU)
    jro, jrd = jrp.pixel_center_rays(cam2, jcfg)
    ro, rd = rp.pixel_center_rays(tcam, cfg)
    np.testing.assert_allclose(nn(rd), np.asarray(jrd), atol=1e-6)
    np.testing.assert_array_equal(nn(ro), np.asarray(jro))
    pts = np.asarray(jro) + 2.5 * np.asarray(jrd)
    jflat, jvalid = jrp.project(cam2, jcfg, jnp.asarray(pts))
    flat, valid = rp.project(tcam, cfg, tt(pts))
    np.testing.assert_array_equal(nn(valid), np.asarray(jvalid))
    np.testing.assert_array_equal(nn(flat), np.asarray(jflat))


def test_reproject_matches_jax(jax_history):
    _, _, cam, cam2, jcfg, jstate = jax_history
    ref = jrp.reproject(jstate, cam, cam2, jcfg)
    got = rp.reproject(convert.frame_state_from_jax(jstate, CPU),
                       convert.camera_from_jax(cam, CPU),
                       convert.camera_from_jax(cam2, CPU),
                       convert.config_from_jax(jcfg))
    # the warp's targets on the same state
    jro, jrd = jrp.pixel_center_rays(cam, jcfg)
    jt = jnp.minimum(jstate.hit_t, jcfg.max_dis)
    jtarget, _ = jrp.project(cam2, jcfg, jro + jt[:, None] * jrd)
    ro, rd = rp.pixel_center_rays(convert.camera_from_jax(cam, CPU),
                                  convert.config_from_jax(jcfg))
    t = torch.clamp_max(tt(np.asarray(jstate.hit_t)), jcfg.max_dis)
    target, _ = rp.project(convert.camera_from_jax(cam2, CPU),
                           convert.config_from_jax(jcfg),
                           ro + t[:, None] * rd)
    assert (nn(target) == np.asarray(jtarget)).mean() >= 0.999
    for k in ("accum", "hit_t"):
        a, b = nn(getattr(got, k)), np.asarray(getattr(ref, k))
        assert _pixels_close(a, b).mean() >= 0.99, k
    # the sums in lane order: bit-equal where the targets agree
    a, b = nn(got.accum), np.asarray(ref.accum)
    assert (a == b).all(axis=1).mean() >= 0.999
    assert float(got.accum[:, 3].sum()) == pytest.approx(
        float(np.asarray(ref.accum)[:, 3].sum()), rel=1e-5)
    np.testing.assert_array_equal(nn(got.rays.depth),
                                  np.asarray(ref.rays.depth))


def test_render_frame_prev_cam_matches_jax(jax_history):
    scene, env, cam, cam2, jcfg, jstate = jax_history
    j_px, j_next = jinteg.render_frame(scene, env, cam2, jstate, jcfg,
                                       refreshing=True, prev_cam=cam)
    t_px, t_next = tinteg.render_frame(
        convert.scene_from_jax(scene, CPU),
        convert.environment_from_jax(env, CPU),
        convert.camera_from_jax(cam2, CPU),
        convert.frame_state_from_jax(jstate, CPU),
        convert.config_from_jax(jcfg), refreshing=True,
        prev_cam=convert.camera_from_jax(cam, CPU))
    assert _pixels_close(nn(t_px), np.asarray(j_px), rtol=1e-4).mean() \
        >= 0.99
    got = convert.frame_state_to_numpy(t_next)
    for k in ("accum", "hit_t"):
        frac = _pixels_close(got[k], np.asarray(getattr(j_next, k)),
                             rtol=1e-4).mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"


# --- the engine frames: the error after a move, against the JAX package -----

ENGINE = (96, 54)  # the interactive app's 768x432 at --scale 8
ENGINE_MOVE = [0.02, 0.0, 0.0]


def reprojection_errors(target, with_rp, from_zero, tonemap):
    """One frame's error against the converged new view, reprojected and
    from zero ((N, 3) radiance each): the mean and the median of the
    per-pixel mean absolute radiance error, the mean absolute error of the
    tonemapped image, and the share of the radiance error on the pixels
    whose estimate is over ten times ``max(target, 1)`` (HDR history
    carried onto a dim pixel)."""
    out = {}
    tm_target = tonemap(target)
    for name, est in (("reprojected", with_rp), ("from_zero", from_zero)):
        e = np.abs(est - target).mean(axis=1)
        bright = est.max(axis=1) > 10 * np.maximum(target.max(axis=1), 1.0)
        out[name] = dict(radiance=e.mean(), median=np.median(e),
                         tonemapped=np.abs(tonemap(est) - tm_target).mean(),
                         bright_share=e[bright].sum() / e.sum())
    return out


def _engine_errors_port():
    from raytracingpbr_tpu_torch.core.types import make_camera
    from raytracingpbr_tpu_torch.models import demo
    from raytracingpbr_tpu_torch.ops import post
    w, h = ENGINE
    cfg = demo.engine_config().replace(resolution=ENGINE, reprojection=True)
    scene, env = demo.engine_scene(CPU), demo.engine_environment(device=CPU)
    cam = make_camera(aspect=w / h, device=CPU)
    cam2 = _moved(cam, ENGINE_MOVE)
    target = _mean(_frames(scene, env, cam2, cfg, 40))
    hist = _frames(scene, env, cam, cfg, 30)
    _, with_rp = tinteg.render_frame(scene, env, cam2, hist, cfg,
                                     refreshing=True, prev_cam=cam)
    _, from_zero = tinteg.render_frame(scene, env, cam2, hist,
                                       cfg.replace(reprojection=False),
                                       refreshing=True)
    return reprojection_errors(
        target, _mean(with_rp), _mean(from_zero),
        lambda x: nn(post.tonemap(torch.as_tensor(x), cfg)))


def _engine_errors_jax():
    from raytracingpbr_tpu.core.types import make_camera
    from raytracingpbr_tpu.models import demo
    from raytracingpbr_tpu.ops import post
    w, h = ENGINE
    cfg = demo.engine_config().replace(resolution=ENGINE, reprojection=True)
    scene, env = demo.engine_scene(), demo.engine_environment()
    cam = make_camera(aspect=w / h)
    move = jnp.asarray(ENGINE_MOVE, jnp.float32)
    cam2 = cam.replace(lookfrom=cam.lookfrom + move,
                       lookat=cam.lookat + move)

    def frames(c, n, state=None):
        state = state if state is not None else j_make_state(cfg.num_pixels)
        for _ in range(n):
            _, state = jinteg.render_frame(scene, env, c, state, cfg)
        return state

    def mean(state):
        a = np.asarray(state.accum)
        return a[:, :3] / np.maximum(a[:, 3:4], 1.0)
    target = mean(frames(cam2, 40))
    hist = frames(cam, 30)
    _, with_rp = jinteg.render_frame(scene, env, cam2, hist, cfg,
                                     refreshing=True, prev_cam=cam)
    _, from_zero = jinteg.render_frame(scene, env, cam2, hist,
                                       cfg.replace(reprojection=False),
                                       refreshing=True)
    return reprojection_errors(
        target, mean(with_rp), mean(from_zero),
        lambda x: np.asarray(post.tonemap(jnp.asarray(x), cfg)))


def test_engine_reprojection_errors_match_jax():
    """``test_render_frame_reprojection_beats_zero_reset``'s protocol on the
    interactive app's engine frames (96x54, the HDR sky): 40 frames of the
    moved view as the target, 30 of history, then one frame reprojected
    and one from zero. Every error statistic of the port within 1% of the
    JAX package's (a few lanes' paths part between the frameworks over 70
    frames; 0.2% on these). In both, reprojection wins in the tonemapped
    image and in the median pixel's radiance; the mean radiance error,
    which the HDR values decide, orders the two the same way in both."""
    got, ref = _engine_errors_port(), _engine_errors_jax()
    print("engine 96x54 port", got, "JAX", ref)
    for way in ("reprojected", "from_zero"):
        for k, v in ref[way].items():
            assert got[way][k] == pytest.approx(v, rel=1e-2), (way, k)
    for errs in (got, ref):
        for k in ("tonemapped", "median"):
            assert errs["reprojected"][k] < errs["from_zero"][k], k
    order = lambda e: e["reprojected"]["radiance"] < e["from_zero"]["radiance"]
    assert order(got) == order(ref)
