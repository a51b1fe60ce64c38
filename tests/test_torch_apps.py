"""The port's interactive app, preview server and fly-cam against the JAX
package's, and what the progressive app serves and saves when it
compacts.

* the fly-cam (``ops/camera``: ``vec_to_euler``, ``euler_to_vec``,
  ``fly_rotate``) and the damped camera (``smooth_update``) against JAX's
  at atol 1e-6 (the same f32 operations; libm's last ulp may differ);
* an ``InteractiveSession`` command script on the engine scene at 16x9
  (``--scale 48``) with ``--reproject``, against JAX's session: the
  camera within atol 1e-5, the frames per lane at the wavefront tests'
  rtol 1e-4 on at least 99% of lanes;
* ``PreviewServer`` on localhost (``tests/test_models_apps.py``'s
  checks), ``encode_png`` byte for byte against JAX's and its round trip;
* ``progressive --serve`` fetched over localhost while it renders, and
  ``--compact-every``: a permutation that is not the identity, the saved
  ``final.png`` equal to the raster of the saved checkpoint's pixels, and
  that checkpoint bit-equal to the one a run without compaction saves.
"""
import io
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.apps.interactive import InteractiveSession as JSession
from raytracingpbr_tpu.io import image as jimage
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import camera as jcam
from raytracingpbr_tpu_torch.apps import interactive, preview, progressive
from raytracingpbr_tpu_torch.io import checkpoint as ckpt
from raytracingpbr_tpu_torch.io import image as timage
from raytracingpbr_tpu_torch.ops import camera as tcam
from raytracingpbr_tpu_torch.ops import compact as tcompact

from .torch_helpers import CPU, nn, tt

# moves, lens and exposure changes, then the rotations: JAX's session
# cannot move after a rotation (see test_move_after_rotation)
SCRIPT = ["w", "w", "d", "z+", "v+", "s", "x+", "c-", "a", "v-", "l", "u",
          "r", "n"]


# --- the fly-cam and the damped camera ---------------------------------------


@pytest.mark.parametrize("v", [(0, 0, 1), (1, 0, 0), (0.3, 0.5, -0.8),
                               (0.0, 0.999, 0.04)])
def test_vec_euler_matches_jax(v):
    f = np.asarray(v, np.float32)
    f = f / np.linalg.norm(f)
    jyaw, jpitch = jcam.vec_to_euler(jnp.asarray(f))
    yaw, pitch = tcam.vec_to_euler(tt(f))
    np.testing.assert_allclose([float(yaw), float(pitch)],
                               [float(jyaw), float(jpitch)], atol=1e-6)
    back = tcam.euler_to_vec(yaw, pitch)
    np.testing.assert_allclose(nn(back), f, atol=1e-6)
    np.testing.assert_allclose(nn(back), np.asarray(
        jcam.euler_to_vec(jyaw, jpitch)), atol=1e-6)


@pytest.mark.parametrize("d_yaw,d_pitch", [(0.0, 10.0), (np.pi / 2, 0.0),
                                           (-0.3, 0.2), (0.05, -10.0)])
def test_fly_rotate_matches_jax(d_yaw, d_pitch):
    pos = np.array([0.1, -0.2, 4.0], np.float32)
    look = np.array([0.0, -0.2, 3.0], np.float32)
    ref = np.asarray(jcam.fly_rotate(jnp.asarray(pos), jnp.asarray(look),
                                     d_yaw, d_pitch))
    got = nn(tcam.fly_rotate(tt(pos), tt(look), d_yaw, d_pitch))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    front = got - pos
    # the gimbal clamp: never past +-0.999 pi / 2
    assert abs(front[1]) <= np.sin(np.pi / 2 * 0.999) + 1e-6


def test_smooth_camera_matches_jax():
    js = jcam.make_smooth_camera((0, 0, 0), (0, 0, -1))
    ts = tcam.make_smooth_camera((0, 0, 0), (0, 0, -1), device=CPU)
    tp, tl, up = [1.0, 0.0, 0.0], [1.0, 0.0, -1.0], [0.0, 1.0, 0.0]
    for _ in range(50):
        js = jcam.smooth_update(js, 0.05, jnp.asarray(tp), jnp.asarray(tl),
                                jnp.asarray(up))
        ts = tcam.smooth_update(ts, 0.05, tt(tp), tt(tl), tt(up))
        for k in ("position", "lookat", "up"):
            np.testing.assert_allclose(nn(getattr(ts, k)),
                                       np.asarray(getattr(js, k)),
                                       atol=1e-6)
        assert bool(ts.moving) == bool(js.moving)
    np.testing.assert_allclose(nn(ts.position), [1, 0, 0], atol=1e-3)
    assert not bool(ts.moving)  # settled


# --- the interactive session -------------------------------------------------


def _lanes_close(a, b, rtol=1e-4, atol=1e-6):
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def test_interactive_script_matches_jax(tmp_path):
    """The same command script through both sessions, reprojecting on
    every move, frame by frame."""
    tsess = interactive.session_setup(48, reproject=True, device=CPU,
                                      out_dir=str(tmp_path / "t"))
    jcfg = jdemo.engine_config().replace(resolution=tsess.cfg.resolution,
                                         reprojection=True)
    jsess = JSession(jdemo.engine_scene(), jdemo.engine_environment(), jcfg,
                     out_dir=str(tmp_path / "j"))
    tsess.step()
    jsess.step()
    moves = 0
    for cmd in SCRIPT:
        tsess.handle(cmd)
        jsess.handle(cmd)
        moves += bool(tsess.smooth.moving)
        assert bool(tsess.smooth.moving) == bool(jsess.smooth.moving)
        np.testing.assert_allclose(nn(tsess.smooth.position),
                                   np.asarray(jsess.smooth.position),
                                   atol=1e-5)
        np.testing.assert_allclose(nn(tsess.smooth.lookat),
                                   np.asarray(jsess.smooth.lookat),
                                   atol=1e-5)
        assert (tsess.vfov, tsess.aperture, tsess.focus, tsess.exposure) \
            == (jsess.vfov, jsess.aperture, jsess.focus, jsess.exposure)
        frac = _lanes_close(nn(tsess.pixels), np.asarray(jsess.pixels))
        assert frac.mean() >= 0.99, (cmd, frac.mean())
    assert moves >= 8  # the script reprojected
    a, b = nn(tsess.state.accum), np.asarray(jsess.state.accum)
    assert _lanes_close(a, b).mean() >= 0.99
    assert tsess.frames == jsess.frames == len(SCRIPT) + 1


def test_move_after_rotation(tmp_path):
    """A reference fault the port does not copy: JAX's session keeps the
    rotated lookat as a read-only view of a jax array
    (``raytracingpbr_tpu/apps/interactive.py:95``), so the next move's
    in-place add raises; the port's moves."""
    tsess = interactive.session_setup(48, device=CPU,
                                      out_dir=str(tmp_path / "t"))
    jcfg = jdemo.engine_config().replace(resolution=tsess.cfg.resolution)
    jsess = JSession(jdemo.engine_scene(), jdemo.engine_environment(), jcfg,
                     out_dir=str(tmp_path / "j"))
    tsess.run_commands(["l", "d"])
    jsess.handle("l")
    with pytest.raises(ValueError, match="read-only"):
        jsess.handle("d")
    assert tsess.target_pos[0] > 0.1  # moved right
    assert tsess.frames == 2


def test_interactive_main_reads_commands(tmp_path, capsys):
    out = tmp_path / "shots"
    interactive.main(["--scale", "48", "--reproject", "--device", "cpu",
                      "--out", str(out)],
                     stdin=io.StringIO("w\nl\ng\nq\nw\n"))
    text = capsys.readouterr().out
    assert "interactive session ready" in text
    assert text.count("frame ") == 3  # w, l, g; q ends the session
    shots = os.listdir(out)
    assert len(shots) == 1
    img = timage.read_png(str(out / shots[0]))
    assert img.shape == (9, 16, 3)


# --- the preview server and PNG encoding --------------------------------------


def test_preview_server():
    srv = preview.PreviewServer(0, host="127.0.0.1").start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/frame.png", timeout=5)
        img = np.zeros((12, 16, 3), np.float32)
        img[:, :, 0] = 1.0
        srv.update(img, frame=7, mean_spp=3.5)
        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"<img" in page
        r = urllib.request.urlopen(base + "/frame.png", timeout=5)
        body = r.read()
        assert r.headers["Content-Type"] == "image/png"
        assert body == timage.encode_png(img)
        stats = json.loads(urllib.request.urlopen(
            base + "/stats", timeout=5).read())
        assert stats["frame"] == 7 and stats["mean_spp"] == 3.5
        r = urllib.request.urlopen(base + "/stream", timeout=5)
        assert r.headers["Content-Type"].startswith("multipart/")
        assert r.read(len(b"--frame")) == b"--frame"
        r.close()
    finally:
        srv.stop()


def test_encode_png_matches_jax_and_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.random((9, 13, 3)).astype(np.float32) * 1.2 - 0.1
    data = timage.encode_png(img)
    assert data == jimage.encode_png(img)
    p = tmp_path / "x.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(
        timage.read_png(str(p)),
        (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
    u8 = (rng.random((5, 7, 3)) * 255).astype(np.uint8)
    p.write_bytes(timage.encode_png(u8, level=9))
    np.testing.assert_array_equal(timage.read_png(str(p)), u8)


# --- the progressive app: --serve and --compact-every -------------------------


def test_progressive_serve_over_localhost(tmp_path, monkeypatch):
    """The daemon publishes its frames while it renders: /frame.png and
    /stats fetched from another thread mid-run."""
    started = threading.Event()
    orig_start = preview.PreviewServer.start

    def capture_start(self):
        out = orig_start(self)
        capture_start.srv = self
        started.set()
        return out
    monkeypatch.setattr(preview.PreviewServer, "start", capture_start)
    fetched = {}
    seen = threading.Event()
    orig_update = preview.PreviewServer.update

    def update_then_fetch(self, img, **stats):
        orig_update(self, img, **stats)
        if stats["frame"] == 2 and not seen.is_set():
            base = f"http://127.0.0.1:{self.port}"
            fetched["png"] = urllib.request.urlopen(
                base + "/frame.png", timeout=5).read()
            fetched["stats"] = json.loads(urllib.request.urlopen(
                base + "/stats", timeout=5).read())
            fetched["img"] = img
            seen.set()
    monkeypatch.setattr(preview.PreviewServer, "update", update_then_fetch)
    scene, env, cam, cfg, exposure = progressive.scene_setup(
        "cornell", 40, device=CPU)
    progressive.run(scene, env, cam, cfg, str(tmp_path), frames=3,
                    exposure=exposure, serve=0)
    assert started.is_set() and seen.is_set()
    assert fetched["png"] == timage.encode_png(fetched["img"])
    assert fetched["stats"]["frame"] == 2
    assert fetched["stats"]["mean_spp"] > 0
    assert capture_start.srv._httpd is None  # stopped at the end


def test_progressive_compact_every_saves_the_raster(tmp_path, monkeypatch):
    """With compaction the saved PNG is the raster of the checkpoint's
    pixels (the JAX app's saved PNGs come out scrambled here), under a
    permutation forced off the identity; the checkpoint is bit-equal to
    one saved without compaction."""
    moved = []
    orig = tcompact.compact_frame_state

    def record(state, pixel_id, threshold):
        out = orig(state, pixel_id, threshold)
        moved.append(not torch.equal(out[1], pixel_id))
        return out
    monkeypatch.setattr(tcompact, "compact_frame_state", record)
    scene, env, cam, cfg, exposure = progressive.scene_setup(
        "cornell", 40, adaptive=True, device=CPU)
    # the noise metric falls as ~1 / frames: at 0.3 about 1% of the
    # pixels are active from the third frame, so the compactions after
    # frames 4 and 6 move lanes
    cfg = cfg.replace(noise_threshold=0.3)
    runs = {}
    for every in (2, 0):
        out = str(tmp_path / f"every{every}")
        progressive.run(scene, env, cam, cfg, out, frames=6,
                        exposure=exposure, compact_every=every)
        runs[every] = out
    assert len(moved) == 3 and any(moved)
    state, meta = ckpt.load(os.path.join(runs[2], "state.npz"), device=CPU)
    assert meta["frame"] == 6
    raster = nn(state.pixels).reshape(cfg.width, cfg.height, 3).transpose(
        1, 0, 2)[::-1]
    saved = timage.read_png(os.path.join(runs[2], "final.png"))
    np.testing.assert_array_equal(saved, timage._to_u8(raster))
    np.testing.assert_array_equal(
        saved, timage.read_png(os.path.join(runs[0], "final.png")))
    plain, _ = ckpt.load(os.path.join(runs[0], "state.npz"), device=CPU)
    for k in ("accum", "pixels", "noise", "respawn", "hit_t", "march_state",
              "march_cum"):
        assert torch.equal(getattr(state, k), getattr(plain, k)), k
    assert torch.equal(state.rays.origin, plain.rays.origin)
