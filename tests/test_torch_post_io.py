"""The last IO, post and metrics modules of the port against the JAX
package on the CPU: ``ops/post.denoise`` and ``inject_dropout_noise``
(``tests/test_post.py``'s properties, then equality at 1e-6 on seeded
inputs), the denoise demo against JAX's ``run``, the Radiance codec
(``io/image.write_hdr`` / ``read_hdr`` / ``hdr_to_env_layout``: the native
codec's bytes, flat and run-length-encoded scanlines), the tetrahedron
normal, and ``utils/metrics.ssim`` / ``block_corr``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.apps import denoise_demo as jdemo
from raytracingpbr_tpu.io import image as jimage
from raytracingpbr_tpu.ops import post as jpost
from raytracingpbr_tpu.ops import scene as jscene
from raytracingpbr_tpu.ops.scene import ObjectSpec as JSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu.utils import metrics as jmetrics
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.apps import denoise_demo
from raytracingpbr_tpu_torch.io import image as timage
from raytracingpbr_tpu_torch.ops import post
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.utils import metrics

from .torch_helpers import CPU, nn, tt


# --- denoise and dropout ----------------------------------------------------

def test_denoise_fills_dark_holes():
    img = torch.full((8, 8, 3), 0.8)
    img[4, 4] = 0.0  # a hole
    out = post.denoise(img, img, threshold=0.2)
    assert float(out[4, 4].mean()) == pytest.approx(0.8, rel=1e-5)
    # pixels that are no hole keep the blend
    assert float(out[2, 2].mean()) == pytest.approx(0.8, rel=1e-5)


def test_dropout_noise_unbiased():
    rng = np.random.default_rng(0)
    u = tt(rng.uniform(size=20000), torch.float32)
    noisy = nn(post.inject_dropout_noise(torch.ones((20000, 3)), u,
                                         keep=0.5))
    assert noisy.mean() == pytest.approx(1.0, abs=0.02)
    assert set(np.unique(noisy.round(3))) == {0.0, 2.0}


@pytest.mark.parametrize("threshold,blend", [(0.2, 0.2), (0.5, 0.7)])
def test_denoise_and_dropout_match_jax(threshold, blend):
    """Seeded frames with holes and a feedback buffer, at the image's
    edges too: the port's output within 1e-6 of JAX's."""
    rng = np.random.default_rng(7)
    frame = rng.uniform(0, 1.5, (13, 17, 3)).astype(np.float32)
    feedback = rng.uniform(0, 1.5, (13, 17, 3)).astype(np.float32)
    u = rng.uniform(size=(13, 17)).astype(np.float32)
    frame = np.asarray(jpost.inject_dropout_noise(jnp.asarray(frame),
                                                  jnp.asarray(u), 0.6))
    np.testing.assert_allclose(
        nn(post.inject_dropout_noise(tt(frame), tt(u), 0.6)),
        np.asarray(jpost.inject_dropout_noise(jnp.asarray(frame),
                                              jnp.asarray(u), 0.6)),
        atol=1e-6, rtol=0)
    want = np.asarray(jpost.denoise(jnp.asarray(frame),
                                    jnp.asarray(feedback), threshold, blend))
    got = nn(post.denoise(tt(frame), tt(feedback), threshold, blend))
    assert (frame.max(-1) == 0).any()  # holes to fill
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_dropout_matches_jax():
    rng = np.random.default_rng(3)
    px = rng.uniform(0, 4, (64, 3)).astype(np.float32)
    u = rng.uniform(size=64).astype(np.float32)
    for keep in (0.3, 0.5, 0.9):
        want = np.asarray(jpost.inject_dropout_noise(jnp.asarray(px),
                                                     jnp.asarray(u), keep))
        got = nn(post.inject_dropout_noise(tt(px), tt(u), keep))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_denoise_demo_matches_jax(tmp_path):
    """The demo at 48x24, 6 steps: noisy and denoised images within 1e-5
    of JAX's ``run``; the PNGs are written."""
    want = jdemo.run(steps=6, resolution=(48, 24))
    got = denoise_demo.run(steps=6, resolution=(48, 24),
                           out_dir=str(tmp_path), device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (24, 48, 3)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-6)
    assert (tmp_path / "noisy.png").exists()
    assert (tmp_path / "denoised.png").exists()
    denoise_demo.main(["--steps", "1", "--resolution", "16x8", "--device",
                       "cpu", "--out", str(tmp_path / "cli")])
    assert timage.read_png(str(tmp_path / "cli" / "denoised.png")).shape == (
        8, 16, 3)
    if not torch.cuda.is_available():  # the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            denoise_demo.run(steps=1, resolution=(8, 4))


# --- the Radiance codec -----------------------------------------------------

def _hdr_image(seed=2, h=24, w=48):
    rng = np.random.default_rng(seed)
    # a shared exponent a pixel: per-pixel dynamic range
    img = (rng.uniform(0.05, 1, (h, w, 3))
           * rng.choice([0.01, 1.0, 100.0], (h, w, 1))).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = 1e-33  # below the black cut
    img[2, 2] = (3e4, 0.0, 1.0)
    return img


def test_hdr_roundtrip(tmp_path):
    hdr = _hdr_image()
    p = str(tmp_path / "t.hdr")
    timage.write_hdr(p, hdr)
    back = timage.read_hdr(p)
    assert back.dtype == np.float32 and back.shape == hdr.shape
    # half a mantissa step of the pixel's largest channel; black below
    # the codec's cut of 1e-32
    bound = np.maximum(hdr.max(-1, keepdims=True) / 128, 1e-32)
    assert (np.abs(back - hdr) <= bound).all()


def test_hdr_bytes_and_floats_match_the_native_codec(tmp_path):
    """The port writes the native codec's bytes, and reads a file the JAX
    package's ``write_hdr`` wrote into its floats."""
    hdr = _hdr_image(5, 7, 19)
    pj, pt = str(tmp_path / "j.hdr"), str(tmp_path / "t.hdr")
    jimage.write_hdr(pj, hdr)
    timage.write_hdr(pt, hdr)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    np.testing.assert_array_equal(timage.read_hdr(pj), jimage.read_hdr(pj))


def _rle_plane(row: np.ndarray) -> bytes:
    """New-style RLE of one component plane: runs of 3+ equal bytes as
    runs, the rest as literals of at most 128."""
    out, x, w = bytearray(), 0, len(row)
    while x < w:
        run = 1
        while x + run < w and run < 127 and row[x + run] == row[x]:
            run += 1
        if run >= 3:
            out += bytes([128 + run, row[x]])
            x += run
            continue
        start = x
        while x < w and x - start < 128:
            if (x + 2 < w and row[x] == row[x + 1] == row[x + 2]):
                break
            x += 1
        out += bytes([x - start]) + row[start:x].tobytes()
    return bytes(out)


def test_read_hdr_rle_scanlines_match_the_native_codec(tmp_path):
    """A file of new-style run-length-encoded scanlines (runs and
    literals, one flat scanline among them) reads as the native codec
    reads it, and as the flat file of the same RGBE bytes."""
    hdr = _hdr_image(9, 6, 40)
    hdr[:, 10:30] = hdr[:, 10:11]  # runs
    flat = timage.encode_hdr(hdr)
    head_end = flat.index(b"+X 40\n") + 6
    rgbe = np.frombuffer(flat[head_end:], np.uint8).reshape(6, 40, 4)
    body = bytearray()
    for y in range(6):
        if y == 3:  # a flat scanline between encoded ones
            body += rgbe[y].tobytes()
            continue
        body += bytes([2, 2, 0, 40])
        for c in range(4):
            body += _rle_plane(rgbe[y, :, c])
    p = tmp_path / "rle.hdr"
    p.write_bytes(flat[:head_end] + bytes(body))
    got = timage.read_hdr(str(p))
    np.testing.assert_array_equal(got, jimage.read_hdr(str(p)))
    q = tmp_path / "flat.hdr"
    q.write_bytes(flat)
    np.testing.assert_array_equal(got, timage.read_hdr(str(q)))
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(flat[:head_end] + bytes([2, 2, 0, 40, 0]))
    with pytest.raises(ValueError):
        timage.read_hdr(str(bad))


def test_hdr_env_layout():
    img = np.zeros((2, 4, 3), np.float32)
    img[0, 1] = 7.0  # top row, x = 1
    env = timage.hdr_to_env_layout(img)
    assert env.shape == (4, 2, 3)
    np.testing.assert_allclose(env[1, 1], 7.0)  # the top row is y = h - 1
    np.testing.assert_array_equal(env, jimage.hdr_to_env_layout(img))


# --- the tetrahedron normal -------------------------------------------------

def _jax_scene():
    return jscene.make_scene([
        JSpec(JSHAPE.SPHERE, position=(0, 0, 0), scale=(1, 1, 1)),
        JSpec(JSHAPE.BOX, position=(3, 0, 0), scale=(1, 1, 1)),
        JSpec(JSHAPE.SPHERE, position=(-3, 0, 0), scale=(0.5, 1, 1)),
        JSpec(JSHAPE.CYLINDER, position=(0, 0, 5), scale=(1, 1, 1)),
    ], box_round=0.0)


def test_normal_analytic_matches_tetrahedron():
    """``tests/test_scene.py``'s check on the port, and the port's
    tetrahedron normal against JAX's, on every object of the scene, at
    atol 2e-4: the estimate differences distances 0.003 apart, so the
    last bit of a distance of up to ~5 (4.8e-7) becomes ~4e-5 of the
    normal."""
    js = _jax_scene()
    ts = convert.scene_from_jax(js, CPU)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(32, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = (d * 1.001).astype(np.float32)
    idx = np.zeros(32, np.int32)
    na = nn(tscene.calc_normal(ts, tt(idx), tt(p)))
    nt = nn(tscene.calc_normal_tetrahedron(ts, tt(idx), tt(p)))
    np.testing.assert_allclose(na, nt, atol=5e-3)

    centers = np.array([[0, 0, 0], [3, 0, 0], [-3, 0, 0], [0, 0, 5]],
                       np.float32)
    idx = rng.integers(0, 4, 64).astype(np.int32)
    q = (centers[idx] + rng.normal(0, 0.8, (64, 3))).astype(np.float32)
    want = np.asarray(jscene.calc_normal_tetrahedron(
        js, jnp.asarray(idx), jnp.asarray(q)))
    got = nn(tscene.calc_normal_tetrahedron(ts, tt(idx), tt(q)))
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


# --- metrics ----------------------------------------------------------------

def test_ssim_and_block_corr_match_jax():
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    u8 = (b * 255).astype(np.uint8)
    small = a[:8, :9]
    for x, y in ((a, b), (a, u8), (small, small[::-1]), (a[..., 0],
                                                          b[..., 0])):
        assert metrics.ssim(x, y) == jmetrics.ssim(x, y)
    assert metrics.ssim(a, a) == pytest.approx(1.0)
    for k in (4, 8):
        assert metrics.block_corr(a, b, k) == jmetrics.block_corr(a, b, k)
    assert metrics.block_corr(a, b) == jmetrics.block_corr(a, b)
    assert metrics.block_corr(a, a) == pytest.approx(1.0)


# --- profiling --------------------------------------------------------------

def test_time_fn_and_trace(tmp_path):
    """``time_fn`` gives seconds a call after its warm-up calls (the CPU's
    wall time here). (The profiler trace around a section is gone: the
    program's spans, ``tests/test_torch_profiling.py``, took its place.)"""
    from raytracingpbr_tpu_torch.utils import profiling
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return {"y": (x * scale).sum(), "z": [x]}
    sec = profiling.time_fn(fn, torch.ones(1000), warmup=2, iters=3,
                            scale=2.0)
    assert sec > 0 and len(calls) == 5
    assert not hasattr(profiling, "xprof_trace")
