"""Adaptive frame compaction of the port (``ops/compact.py``) against the
JAX package's, and its lane-order invariance.

The wavefront keys every draw on ``pixel_id`` and the split-march carry
moves with its lane, so a render that repacks its state actives-first
every other frame gives every pixel the same bits as one that does not
(``tests/test_compact.py``'s property); here the permutation is asserted
not to be the identity. Against JAX the compacted frames agree per lane at
the wavefront tests' tolerance (rtol 1e-4, atol 1e-6, at least 99% of
lanes; ``test_torch_wavefront.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops import compact as jcompact
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.pallas import march_kernel as mk
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.core.types import Rays, make_frame_state
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import compact as tcompact
from raytracingpbr_tpu_torch.ops import integrator as tinteg

from .torch_helpers import CPU, nn, tt

FRAMES = 6


def _jcfg():
    """``tests/test_compact.py``'s config, save the threshold: at its 1e-2
    every pixel stays active for these frames, so its compaction is the
    identity. At 0.22 about 97% of the pixels are gated off after the
    fourth frame (the noise metric falls as 1 / frames here), so the
    compactions after frames 4 and 6 move lanes."""
    return jcornell.full_config().replace(
        resolution=(32, 24), max_raymarch=64, max_raytrace=8,
        samples_per_frame=2, adaptive_sampling=True, noise_threshold=0.22)


def _leaves(state):
    """(name, numpy) of every leaf of a port FrameState."""
    out = [(f"rays.{f.name}", nn(getattr(state.rays, f.name)))
           for f in dataclasses.fields(Rays)]
    return out + [(f.name, nn(getattr(state, f.name)))
                  for f in dataclasses.fields(state) if f.name != "rays"]


def _port_frames(cfg, compact_every):
    """FRAMES frames of the port's render_frame_tile, compacting after
    every ``compact_every``-th (0: never). Returns (pixels and the map
    they were rendered over, state, its map, whether a compaction moved a
    lane)."""
    scene, env, cam = (tcornell.full_scene(CPU), tcornell.sky(CPU),
                       tcornell.full_camera(CPU))
    state = make_frame_state(cfg.num_pixels, CPU)
    pid = torch.arange(cfg.num_pixels)
    moved = False
    for k in range(FRAMES):
        px, state = tinteg.render_frame_tile(scene, env, cam, state, cfg,
                                             pid)
        px_pid = pid
        if compact_every and k % compact_every == compact_every - 1:
            state, new = tcompact.compact_frame_state(state, pid,
                                                      cfg.noise_threshold)
            moved = moved or not torch.equal(new, pid)
            pid = new
    return (px, px_pid), state, pid, moved


@pytest.fixture(scope="module")
def port_runs():
    cfg = convert.config_from_jax(_jcfg())
    return cfg, _port_frames(cfg, 0), _port_frames(cfg, 2)


# the JAX package's two stable actives-first partitions: the frame
# compaction's, and the phased march's of the lanes not done
PERM_REFS = {
    "compact": lambda active: jcompact.actives_first_perm(
        jnp.asarray(active)),
    "phased_march": lambda active: mk._partition_active(
        jnp.asarray(~active, jnp.int32)),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ref", sorted(PERM_REFS))
def test_actives_first_perm_matches_jax(ref, seed):
    active = np.random.default_rng(seed).random(997) < 0.4
    want = np.asarray(PERM_REFS[ref](active))
    got = nn(tcompact.actives_first_perm(tt(active)))
    np.testing.assert_array_equal(got, want)
    assert active[got[:active.sum()]].all()
    assert nn(tcompact.actives_first_perm(tt([False, True, False, True, True,
                                             False, True]))).tolist() \
        == [1, 3, 4, 6, 0, 2, 5]


def test_compact_uncompact_roundtrip():
    """Every leaf in its own dtype (respawn i64, march_cum i32) comes back
    bit for bit."""
    state = make_frame_state(96, CPU)
    g = torch.Generator().manual_seed(0)
    state = state.replace(
        respawn=torch.randint(0, 2**40, (96,), generator=g),
        march_cum=torch.randint(0, 99, (96,), generator=g,
                                dtype=torch.int32),
        noise=torch.rand(96, generator=g),
        accum=torch.rand((96, 4), generator=g),
        march_state=torch.rand((96, 4), generator=g))
    pid = torch.randperm(96, generator=g)
    packed, new_pid = tcompact.compact_frame_state(state, pid, 0.5)
    assert not torch.equal(new_pid, pid)
    assert bool((packed.noise[:int((state.noise > 0.5).sum())] > 0.5).all())
    back = tcompact.uncompact_frame_state(packed, new_pid)
    raster = tcompact.uncompact_frame_state(state, pid)
    for (name, a), (_, b) in zip(_leaves(back), _leaves(raster)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_compacted_render_bit_identical(port_runs):
    """``tests/test_compact.py``'s property on the port, under a
    permutation that is not the identity: the last frame renders over a
    map that the compaction after the fourth moved."""
    cfg, ((px_a, _), state_a, _, _), ((px_b, px_pid), state_b, pid_b,
                                      moved) = port_runs
    assert moved
    assert not torch.equal(px_pid, torch.arange(cfg.num_pixels))
    act = nn(state_b.noise > cfg.noise_threshold)
    assert 0 < act.sum() < act.size
    assert act[:act.sum()].all()  # actives lead
    np.testing.assert_array_equal(
        tcompact.scatter_pixels(px_b, px_pid, cfg), nn(px_a))
    back = tcompact.uncompact_frame_state(state_b, pid_b)
    for (name, a), (_, b) in zip(_leaves(back), _leaves(state_a)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _lanes_close(a, b, rtol=1e-4, atol=1e-6):
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


def test_compacted_frames_match_jax(port_runs):
    """JAX's compacted render (``tests/test_compact.py``'s loop) against
    the port's, both put back in raster order."""
    jcfg = _jcfg()
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    tile = jax.jit(lambda st, pid: jinteg.render_frame_tile(
        scene, env, cam, st, jcfg, pid))
    state = j_make_state(jcfg.num_pixels)
    pid = jnp.arange(jcfg.num_pixels, dtype=jnp.uint32)
    for k in range(FRAMES):
        px, state = tile(state, pid)
        px_pid = pid
        if k % 2 == 1:
            state, pid = jcompact.compact_frame_state(state, pid,
                                                      jcfg.noise_threshold)
    j_raster = jcompact.scatter_pixels(px, px_pid, jcfg)
    j_state = convert.frame_state_to_numpy(convert.frame_state_from_jax(
        jcompact.uncompact_frame_state(state, pid), CPU))

    cfg, _, ((px_b, px_pid), state_b, pid_b, _) = port_runs
    t_raster = tcompact.scatter_pixels(px_b, px_pid, cfg)
    assert _lanes_close(t_raster, j_raster).mean() >= 0.99
    t_state = convert.frame_state_to_numpy(
        tcompact.uncompact_frame_state(state_b, pid_b))
    for k in ("accum", "noise", "hit_t", "rays.origin", "march_state"):
        frac = _lanes_close(t_state[k], j_state[k]).mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"
    assert (t_state["respawn"] == j_state["respawn"]).mean() >= 0.99


def test_scatter_pixels_matches_jax():
    rng = np.random.default_rng(4)
    cfg = convert.config_from_jax(_jcfg())
    px = rng.random((cfg.num_pixels, 3)).astype(np.float32)
    pid = rng.permutation(cfg.num_pixels)
    ref = jcompact.scatter_pixels(jnp.asarray(px),
                                  jnp.asarray(pid, jnp.uint32), _jcfg())
    np.testing.assert_array_equal(
        tcompact.scatter_pixels(tt(px), tt(pid), cfg), ref)
