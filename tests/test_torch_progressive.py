"""The port's progressive daemon (``apps/progressive``) and what it is made
of, on the CPU at small sizes:

* checkpoints both ways: a JAX-written ``state.npz`` loads in the port
  (and resumes in the port's app), a port-written one loads in JAX's
  ``io.checkpoint.load``, with equal arrays in each package's dtypes; the
  legacy layouts' defaults as JAX reads them;
* resume bit-identical: N frames straight equal k frames, a checkpoint, a
  load and N - k frames, with NEE on, and the app's two runs equal one
  straight render of as many frames;
* the app's outputs (PNGs, checkpoint, metrics, debug views), ``--nee``'s
  ValueError on a sky that is not HDR, and ``--serve`` and
  ``--compact-every`` running;
* ``MetricsLogger.frame_stats`` against JAX's, and ``utils/validate``.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.io import checkpoint as jckpt
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.utils.profiling import MetricsLogger as JLogger
from raytracingpbr_tpu_torch.apps import progressive
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.io import checkpoint as ckpt
from raytracingpbr_tpu_torch.io.image import read_png
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.utils import validate
from raytracingpbr_tpu_torch.utils.profiling import MetricsLogger

from .torch_helpers import CPU, nn

KEYS = ("origin", "direction", "color", "depth", "accum", "frame",
        "diff_accum", "noise", "pixels", "respawn", "hit_t", "sky_w",
        "march_state", "march_cum")
APP = ["--scene", "demo", "--scale", "32", "--device", "cpu"]


def _leaves(state) -> dict:
    """A FrameState of either package as {checkpoint key: numpy}."""
    rays = {k: getattr(state.rays, k) for k in ("origin", "direction",
                                                "color", "depth")}
    return {k: nn(rays[k] if k in rays else getattr(state, k))
            for k in KEYS}


@pytest.fixture(scope="module")
def jax_state():
    """A mid-flight JAX state: two wavefront frames of the full Cornell
    box at 8x8 (split-march carry in flight, respawn counters moved)."""
    cfg = jcornell.full_config().replace(resolution=(8, 8), max_raymarch=64,
                                         max_raytrace=8, samples_per_frame=2,
                                         march_split=16)
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st, cfg))
    st = j_make_state(cfg.num_pixels)
    for _ in range(2):
        _, st = frame(st)
    assert int(np.asarray(st.march_cum).max()) > 0
    return st


def test_jax_checkpoint_loads_in_the_port(tmp_path, jax_state):
    p = str(tmp_path / "state.npz")
    jckpt.save(p, jax_state, meta={"frame": 2})
    got, meta = ckpt.load(p, device=CPU)
    assert meta == {"frame": 2}
    assert got.frame.dtype == got.respawn.dtype == torch.int64
    ref = _leaves(jax_state)
    for k, v in _leaves(got).items():
        np.testing.assert_array_equal(v, ref[k].astype(v.dtype), err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path, jax_state):
    p = str(tmp_path / "state.npz")
    jckpt.save(p, jax_state)
    state, _ = ckpt.load(p, device=CPU)
    state = state.replace(frame=state.frame + 5,
                          respawn=state.respawn + 2**32 - 1)
    q = str(tmp_path / "port.npz")
    ckpt.save(q, state, meta={"note": "x"})
    back, meta = jckpt.load(q)
    assert meta == {"note": "x"}
    ref = _leaves(jax_state)
    got = _leaves(back)
    assert got["respawn"].dtype == np.uint32 and got["frame"].dtype == np.int32
    assert int(got["frame"]) == int(ref["frame"]) + 5
    # the counter wraps as JAX's uint32 does
    np.testing.assert_array_equal(got["respawn"], ref["respawn"] - 1)
    for k in KEYS:
        if k not in ("frame", "respawn"):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_legacy_layouts_load_as_in_jax(tmp_path, jax_state):
    """No respawn, hit_t or split-march carry, and the boolean nee_flag in
    place of sky_w: the port fills in what JAX's load fills in."""
    full = _leaves(jax_state)
    old = {k: v for k, v in full.items()
           if k not in ("respawn", "hit_t", "sky_w", "march_state",
                        "march_cum")}
    old["nee_flag"] = (np.arange(64) % 3 == 0)
    p = str(tmp_path / "old.npz")
    np.savez(p, **old)
    got, meta = ckpt.load(p, device=CPU)
    ref, ref_meta = jckpt.load(p)
    assert meta == ref_meta == {}
    ref = _leaves(ref)
    for k, v in _leaves(got).items():
        np.testing.assert_array_equal(v, ref[k].astype(v.dtype), err_msg=k)
    assert nn(got.sky_w).min() == 0.0 and nn(got.sky_w).max() == 1.0


def test_roundtrip_bit_exact(tmp_path):
    state = make_frame_state(64, device=CPU)
    state = state.replace(accum=state.accum + np.pi, frame=state.frame + 17,
                          respawn=state.respawn + 3)
    p = str(tmp_path / "ck.npz")
    ckpt.save(p, state, meta={"note": "x"})
    back, meta = ckpt.load(p, device=CPU)
    assert meta == {"note": "x"}
    for k, v in _leaves(state).items():
        got = _leaves(back)[k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def _render(setup, state, frames):
    scene, env, cam, cfg, exposure = setup
    px = None
    for _ in range(frames):
        px, state = tinteg.render_frame(scene, env, cam, state, cfg,
                                        exposure=exposure)
    return px, state


def test_resume_is_bit_identical(tmp_path):
    """4 frames straight equal 2 frames, a checkpoint, a load and 2 more,
    with NEE on the engine scene."""
    setup = progressive.scene_setup("demo", 32, nee=True, device=CPU)
    n = setup[3].num_pixels
    px_a, straight = _render(setup, make_frame_state(n, CPU), 4)
    _, half = _render(setup, make_frame_state(n, CPU), 2)
    p = str(tmp_path / "mid.npz")
    ckpt.save(p, half)
    resumed, _ = ckpt.load(p, device=CPU)
    px_b, resumed = _render(setup, resumed, 2)
    assert float(straight.accum[:, 3].sum()) > 0
    assert torch.equal(px_a, px_b)
    for k, v in _leaves(straight).items():
        np.testing.assert_array_equal(_leaves(resumed)[k], v, err_msg=k)


def test_app_runs_and_resumes_bit_exactly(tmp_path, capsys):
    """Two short runs of the app (the second resumes from the first's
    checkpoint) equal one straight render of as many frames."""
    out = str(tmp_path / "out")
    metrics = str(tmp_path / "m.jsonl")
    args = [*APP, "--nee", "--minutes", "0.005", "--out", out, "--metrics",
            metrics, "--debug-views", "--validate"]
    progressive.main(args)
    first, _ = ckpt.load(os.path.join(out, "state.npz"), device=CPU)
    progressive.main(args)
    assert f"resumed from frame {int(first.frame)}" in capsys.readouterr().out
    last, meta = ckpt.load(os.path.join(out, "state.npz"), device=CPU)
    frames = int(last.frame)
    assert frames > int(first.frame) and meta == {"frame": frames}
    setup = progressive.scene_setup("demo", 32, nee=True, device=CPU)
    px, straight = _render(setup, make_frame_state(setup[3].num_pixels, CPU),
                           frames)
    for k, v in _leaves(straight).items():
        np.testing.assert_array_equal(_leaves(last)[k], v, err_msg=k)
    for name in ("final.png", "debug_noise.png", "debug_depth.png"):
        assert read_png(os.path.join(out, name)).shape == (13, 24, 3)
    with open(metrics) as f:
        rec = [json.loads(line) for line in f]
    assert [r["frame"] for r in rec] == list(range(1, frames + 1))
    assert rec[-1]["mean_spp"] == pytest.approx(
        float(straight.accum[:, 3].mean()))


def test_jax_checkpoint_resumes_in_the_app(tmp_path, capsys):
    """A JAX-written state.npz of the app's cornell scene (the full box at
    scale 40: 12x12) resumes in the port's app."""
    cfg = jcornell.full_config().replace(resolution=(12, 12))
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st, cfg,
                                                   exposure=0.6))
    st = j_make_state(cfg.num_pixels)
    for _ in range(3):
        _, st = frame(st)
    out = str(tmp_path / "out")
    jckpt.save(os.path.join(out, "state.npz"), st, meta={"frame": 3})
    progressive.main(["--scene", "cornell", "--scale", "40", "--device",
                      "cpu", "--minutes", "0.001", "--out", out])
    assert "resumed from frame 3" in capsys.readouterr().out
    back, _ = ckpt.load(os.path.join(out, "state.npz"), device=CPU)
    assert int(back.frame) > 3
    assert float(back.accum[:, 3].sum()) > float(np.asarray(
        st.accum)[:, 3].sum())


@pytest.mark.parametrize("flag,item", [(["--serve", "0"], "item 16"),
                                       (["--compact-every", "4",
                                         "--adaptive"], "item 14")])
def test_unported_options_raise(tmp_path, flag, item):
    """The options, once unported (they raised, naming ROADMAP ``item``),
    now run: two frames, then the PNGs and the checkpoint
    (``tests/test_torch_apps.py`` holds what they serve and save)."""
    progressive.main([*APP, "--frames", "2", "--out", str(tmp_path), *flag])
    assert {"final.png", "state.npz"} <= set(os.listdir(tmp_path))
    back, _ = ckpt.load(os.path.join(str(tmp_path), "state.npz"), device=CPU)
    assert int(back.frame) == 2


def test_nee_needs_an_hdr_sky(tmp_path):
    with pytest.raises(ValueError, match="HDR"):
        progressive.main(["--scene", "cornell", "--device", "cpu", "--nee",
                          "--out", str(tmp_path)])


def test_frame_stats_match_jax(tmp_path):
    """Every field but ``samples_per_s`` is the JAX package's. That one is
    the frame's own rate in the port: the samples the frame completed (the
    accumulated count's growth since the last frame, the whole count after
    a refresh zeroed it) over its seconds; the JAX package divides the
    whole count by one frame's seconds."""
    rng = np.random.default_rng(0)
    pixels = rng.random((64, 3)).astype(np.float32)
    accum = rng.random((64, 4)).astype(np.float32) * 8
    a = MetricsLogger(str(tmp_path / "a.jsonl"))
    b = JLogger(str(tmp_path / "b.jsonl"))
    got = a.frame_stats(pixels, accum, 0.25, frame=3)
    ref = b.frame_stats(pixels, accum, 0.25, frame=3)
    total = float(accum[:, 3].astype(np.float64).sum())
    assert got.pop("samples_per_s") == pytest.approx(total / 0.25, rel=1e-12)
    ref.pop("samples_per_s")
    assert got == ref
    first = ref
    # the next frame adds 2 samples a pixel in 0.5 s
    accum2 = accum.copy()
    accum2[:, 3] += 2.0
    got = a.frame_stats(pixels, accum2, 0.5, frame=4)
    ref = b.frame_stats(pixels, accum2, 0.5, frame=4)
    grown = float(accum2[:, 3].astype(np.float64).sum()) - total
    assert grown == pytest.approx(128.0, rel=1e-6)
    assert got.pop("samples_per_s") == pytest.approx(grown / 0.5, rel=1e-12)
    ref.pop("samples_per_s")
    assert got == ref
    # a refresh zeroed the count: the frame's own samples are all of it
    fresh = accum.copy()
    fresh[:, 3] = 1.0
    got = a.frame_stats(pixels, fresh, 0.1, frame=5)
    assert got["samples_per_s"] == pytest.approx(64 / 0.1)
    # a logger started on a resumed state counts from that state's samples
    c = MetricsLogger(None, samples=total)
    assert c.frame_stats(pixels, accum2, 0.5)["samples_per_s"] == \
        pytest.approx(grown / 0.5, rel=1e-12)
    a.close()
    b.close()
    with open(tmp_path / "a.jsonl") as f:
        line = json.loads(f.readline())
    assert line["frame"] == 3 and line["mean_spp"] == first["mean_spp"]


def test_validate():
    s = make_frame_state(64, device=CPU)
    h = validate.state_health(s)
    assert h["accum_finite_frac"] == 1.0 and h["origin_absmax"] == 0.0
    validate.assert_state_finite(s)
    s.rays.depth[:4] = 1
    s.rays.direction[:4] = torch.tensor([0.0, 0.0, 1.0])
    assert validate.state_health(s)["live_direction_unit_frac"] == 1.0
    bad = s.replace(accum=s.accum.clone())
    bad.accum[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="accum"):
        validate.assert_state_finite(bad)

    step = validate.nan_guard(lambda st: (st.accum.sum(), st))
    step(s)
    with pytest.raises(FloatingPointError):
        step(bad)
