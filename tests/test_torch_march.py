"""Port march (plain PyTorch) against the JAX march, and the split-march
properties within the port.

Against JAX the bars are those of ``tests/test_pallas.py``: at least 99.9%
hit agreement, t within rtol 1e-3 on agreeing lanes, equal index on lanes
both call a hit (XLA-CPU contracts FMAs where PyTorch rounds every op, so a
long march can flip a boundary decision on a few lanes). Within the port,
chained resumes are bit-identical to one march.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import camera as jcamera
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu_torch.convert import config_from_jax, scene_from_jax
from raytracingpbr_tpu_torch.kernels import march_kernel
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import march as tmarch

from .torch_helpers import nn, random_rays, tt


def cornell_primaries(cfg, n=None, seed=3):
    """Primary camera rays of the JAX package (numpy), optionally a random
    subset of pixels."""
    pid = np.arange(cfg.num_pixels, dtype=np.uint32)
    if n is not None:
        pid = np.random.default_rng(seed).choice(pid, n, replace=False)
    u = jrng.uniform4(jnp.asarray(pid), 0, 1, cfg.seed)
    uv = jcamera.pixel_uv(jnp.asarray(pid), cfg.width, cfg.height, u[0], u[1])
    rays = jcamera.get_ray(jcornell.full_camera(), uv, u[2], u[3])
    return np.asarray(rays.origin), np.asarray(rays.direction)


def _assert_march_bars(ref, got):
    h_ref, h_got = np.asarray(ref.hit), nn(got.hit)
    agree = h_ref == h_got
    assert agree.mean() >= 0.999, f"hit mismatch {1 - agree.mean():.4%}"
    np.testing.assert_allclose(nn(got.t)[agree], np.asarray(ref.t)[agree],
                               rtol=1e-3, atol=1e-3)
    both = h_ref & h_got
    np.testing.assert_array_equal(nn(got.index)[both],
                                  np.asarray(ref.index)[both])


@pytest.mark.parametrize("case", ["cornell_primaries", "cornell_random",
                                  "minimal_random", "engine_rollback"])
def test_plain_march_matches_jax(case):
    if case == "engine_rollback":
        # the ROLLBACK_TO_ONE / CONE variants (K1b's policies)
        js, jcfg = jdemo.engine_scene(), jdemo.engine_config()
        jcfg = jcfg.replace(max_raymarch=128)
        o, d = random_rays(2048, seed=4, center=(0.0, 0.0, 3.5))
    elif case == "minimal_random":
        js = jcornell.minimal_scene()
        jcfg = jcornell.minimal_config().replace(max_raymarch=128)
        o, d = random_rays(2048, seed=1, center=(0.0, 0.0, 0.5),
                           spread=0.3)
    else:
        js = jcornell.full_scene()
        jcfg = jcornell.full_config().replace(resolution=(48, 48),
                                              max_raymarch=160)
        o, d = (cornell_primaries(jcfg) if case == "cornell_primaries"
                else random_rays(2048, seed=2, center=(0.0, 0.0, 0.5),
                                 spread=0.3))
    ref = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), jcfg,
                       differentiable=False, backend="xla")
    got = tmarch.march(scene_from_jax(js), tt(o), tt(d),
                       config_from_jax(jcfg))
    _assert_march_bars(ref, got)
    assert nn(got.hit).mean() > 0.3


def test_plain_resumable_matches_pallas_interpret(monkeypatch):
    """The JAX kernel path itself (Pallas in interpret mode, resume + gate)
    against the port's plain resumable march."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    js = jcornell.full_scene()
    jcfg = jcornell.full_config().replace(resolution=(32, 32),
                                          max_raymarch=32)
    o, d = cornell_primaries(jcfg)
    n = o.shape[0]
    rng = np.random.default_rng(7)
    active = rng.random(n) < 0.8
    init = (rng.uniform(0.005, 1.0, n).astype(np.float32),
            np.ones(n, np.float32), rng.uniform(0, 0.1, n).astype(np.float32),
            np.full(n, 1e3, np.float32))
    ref = jmarch.march_resumable(js, jnp.asarray(o), jnp.asarray(d), jcfg,
                                 active=jnp.asarray(active),
                                 init=tuple(jnp.asarray(v) for v in init),
                                 backend="pallas")
    got = tmarch.march_resumable(scene_from_jax(js), tt(o), tt(d),
                                 config_from_jax(jcfg), active=tt(active),
                                 init=tuple(tt(v) for v in init))
    _assert_march_bars(ref, got)
    for k in ("fin", "done"):
        agree = np.asarray(ref.hit) == nn(got.hit)
        np.testing.assert_array_equal(nn(getattr(got, k))[agree],
                                      np.asarray(getattr(ref, k))[agree])


def _chain(scene, o, d, cfg, budget):
    """Chained budget-B resumes, as the wavefront's split carry runs
    them."""
    n = o.shape[0]
    t = tt(np.full(n, cfg.march_t0, np.float32))
    w = tt(np.full(n, cfg.omega, np.float32))
    s = tt(np.zeros(n, np.float32))
    dd = tt(np.full(n, 1e3, np.float32))
    cum = np.zeros(n, np.int64)
    idx = np.zeros(n, np.int32)
    hit = np.zeros(n, bool)
    live = np.ones(n, bool)
    mcfg = cfg.replace(max_raymarch=budget)
    for _ in range(cfg.max_raymarch // budget):
        rr = tmarch.march_resumable(scene, o, d, mcfg, active=tt(live),
                                    init=(t, w, s, dd))
        cum += nn(rr.fin)
        done_now = live & ((nn(rr.done) > 0) | (cum >= cfg.max_raymarch))
        idx = np.where(live, nn(rr.index), idx)
        hit = np.where(live, nn(rr.hit), hit)
        t, w, s, dd = rr.t, rr.w, rr.s, rr.d  # inactive lanes echo init
        live = live & ~done_now
    return nn(t), idx, hit, cum


@pytest.mark.parametrize("policy", ["constant", "rollback"])
def test_chained_resumes_bit_identical(policy):
    """Chained budget-16 resumes equal one uninterrupted march, lane by lane
    and bit for bit (the property the split wavefront rests on)."""
    scene = tcornell.full_scene()
    cfg = tcornell.full_config().replace(resolution=(48, 48),
                                         max_raymarch=64)
    if policy == "rollback":
        cfg = tcornell.v3_config().replace(resolution=(48, 48),
                                           max_raymarch=64)
    o, d = (tt(v) for v in cornell_primaries(cfg, n=512))
    one = tmarch.march_resumable(scene, o, d, cfg)
    t, idx, hit, cum = _chain(scene, o, d, cfg, 16)
    np.testing.assert_array_equal(t, nn(one.t))
    np.testing.assert_array_equal(hit, nn(one.hit))
    np.testing.assert_array_equal(idx, nn(one.index))
    # consumption: the lane's need, or the full budget if it never converged
    np.testing.assert_array_equal(cum, nn(one.fin))


def test_inactive_lanes_echo_init_and_ragged_n():
    scene = tcornell.full_scene()
    cfg = tcornell.full_config().replace(max_raymarch=32)
    n = 777  # not a multiple of any block size
    o, d = random_rays(n, seed=9, center=(0.0, 0.0, 0.5), spread=0.3)
    rng = np.random.default_rng(9)
    active = rng.random(n) < 0.6
    init = tuple(rng.uniform(0.01, 1.0, n).astype(np.float32)
                 for _ in range(4))
    rr = tmarch.march_resumable(scene, tt(o), tt(d), cfg, active=tt(active),
                                init=tuple(tt(v) for v in init))
    assert all(v.shape == (n,) for v in rr)
    off = ~active
    for k, v in zip("twsd", init):
        np.testing.assert_array_equal(nn(getattr(rr, k))[off], v[off])
    assert (nn(rr.fin)[off] == 0).all() and (nn(rr.done)[off] == 1).all()
    assert (nn(rr.index)[off] == 0).all() and not nn(rr.hit)[off].any()
    fin = nn(rr.fin)[active]
    assert ((fin >= 1) & (fin <= cfg.max_raymarch)).all()
    # unconverged active lanes report the full budget
    np.testing.assert_array_equal(fin[nn(rr.done)[active] == 0],
                                  cfg.max_raymarch)
    # all inactive: nothing marches
    none = tmarch.march_resumable(scene, tt(o), tt(d), cfg,
                                  active=tt(np.zeros(n, bool)))
    assert (nn(none.fin) == 0).all()
    np.testing.assert_array_equal(nn(none.t),
                                  np.full(n, cfg.march_t0, np.float32))


def test_cpu_tensors_take_the_plain_version():
    """The wrapper dispatch: CPU tensors never reach the kernel."""
    scene = tcornell.full_scene()
    cfg = tcornell.full_config().replace(max_raymarch=16)
    o, d = random_rays(64, seed=0)
    before = march_kernel.LAUNCHES
    rr = tmarch.march_resumable(scene, tt(o), tt(d), cfg)
    ref = tmarch.march_resumable_plain(scene, tt(o), tt(d), cfg)
    assert march_kernel.LAUNCHES == before
    for a, b in zip(rr, ref):
        np.testing.assert_array_equal(nn(a), nn(b))


def test_kernel_wrapper_refuses_cpu_and_other_variants():
    scene = tcornell.full_scene()
    o, d = random_rays(8, seed=0)
    with pytest.raises(ValueError):
        march_kernel.march_resumable_cuda(scene, tt(o), tt(d),
                                          tcornell.full_config())
    with pytest.raises(NotImplementedError):
        march_kernel.march_resumable_cuda(scene, tt(o), tt(d),
                                          tcornell.v3_config())
    with pytest.raises(NotImplementedError):
        tmarch.march(scene, tt(o), tt(d), tcornell.full_config(),
                     differentiable=True)


def test_pack_scene_layout():
    scene = tcornell.full_scene()
    p = nn(march_kernel.pack_scene(scene))
    assert p.shape == (scene.num_objects, 32)
    np.testing.assert_array_equal(p[:, 0:3], nn(scene.position))
    np.testing.assert_array_equal(p[:, 3:6], nn(scene.scale))
    np.testing.assert_array_equal(p[:, 6:15],
                                  nn(scene.matrix).reshape(-1, 9))
    np.testing.assert_array_equal(p[:, 15:18], nn(scene.local_offset))
    assert (p[:, 18:] == 0).all()
