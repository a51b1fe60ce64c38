"""Port march (plain PyTorch) against the JAX march, and the split-march
properties within the port.

Against JAX the bars are those of ``tests/test_pallas.py``: at least 99.9%
hit agreement, t within rtol 1e-3 on agreeing lanes, equal index on lanes
both call a hit (XLA-CPU contracts FMAs where PyTorch rounds every op, so a
long march can flip a boundary decision on a few lanes); against JAX's
phased march, the port's one call. Within the port, chained resumes are
bit-identical to one march.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import camera as jcamera
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu.pallas import march_kernel as mk
from raytracingpbr_tpu_torch.convert import config_from_jax, scene_from_jax
from raytracingpbr_tpu_torch.kernels import march_kernel
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.models import demo as tdemo
from raytracingpbr_tpu_torch.ops import march as tmarch

from .torch_helpers import CPU, chained_resumes, nn, random_rays, tt


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
    got = tmarch.march(scene_from_jax(js, CPU), tt(o), tt(d),
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
    got = tmarch.march_resumable(scene_from_jax(js, CPU), tt(o), tt(d),
                                 config_from_jax(jcfg), active=tt(active),
                                 init=tuple(tt(v) for v in init))
    _assert_march_bars(ref, got)
    for k in ("fin", "done"):
        agree = np.asarray(ref.hit) == nn(got.hit)
        np.testing.assert_array_equal(nn(getattr(got, k))[agree],
                                      np.asarray(getattr(ref, k))[agree])


# not a multiple of the TPU tile: JAX pads, the port does not
PHASED_RAYS = 777


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("family", ["minimal", "engine"])
def test_march_equals_jax_phased_march(monkeypatch, family, gated):
    """The port's one march call against the JAX package's phased
    (compacted) march, Pallas in interpret mode, on
    ``tests/test_pallas.py::test_phased_march_bit_equal``'s cases: index,
    hit and fin equal on every lane, t within ``tests/test_pallas.py``'s
    rtol and atol 1e-3 (the two frameworks round the march's arithmetic
    apart in the last ulp). This is why the port may ignore
    ``march_compaction``."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    if family == "minimal":
        js = jcornell.minimal_scene()
        jcfg = jcornell.minimal_config().replace(max_raymarch=256)
    else:
        js, jcfg = jdemo.engine_scene(), jdemo.engine_config().replace(
            max_raymarch=128)
    assert len(mk.resolve_phases(jcfg)) > 1
    o, d = random_rays(PHASED_RAYS, 0)
    gate = (np.random.default_rng(1).random(PHASED_RAYS) < 0.7
            if gated else None)
    jt, ji, jh, jf = mk.march_phased(
        js, jnp.asarray(o), jnp.asarray(d), jcfg,
        active=None if gate is None else jnp.asarray(gate))
    got = tmarch.march_resumable(scene_from_jax(js, CPU), tt(o), tt(d),
                                 config_from_jax(jcfg),
                                 active=None if gate is None else tt(gate))
    np.testing.assert_array_equal(nn(got.hit), np.asarray(jh))
    np.testing.assert_array_equal(nn(got.index), np.asarray(ji))
    np.testing.assert_array_equal(nn(got.fin), np.asarray(jf))
    np.testing.assert_allclose(nn(got.t), np.asarray(jt), rtol=1e-3,
                               atol=1e-3)


def _chain_family(family):
    """(scene, config at a budget of 64, 512 rays) of one march family."""
    if family == "engine_rollback_cone":
        cfg = tdemo.engine_config().replace(max_raymarch=64)
        return (tdemo.engine_scene(CPU), cfg,
                random_rays(512, seed=4, center=(0.0, 0.0, 3.5)))
    if family == "minimal":
        cfg = tcornell.minimal_config().replace(max_raymarch=64)
        return (tcornell.minimal_scene(CPU), cfg,
                random_rays(512, seed=1, center=(0.0, 0.0, 0.5), spread=0.3))
    if family == "cornell_v3_rollback":
        # the primaries converge within 16 trips here: rays from inside
        # the box, some grazing, outlast a call
        cfg = tcornell.v3_config().replace(resolution=(48, 48),
                                           max_raymarch=64)
        return (tcornell.full_scene(CPU), cfg,
                random_rays(512, seed=2, center=(0.0, 0.0, 0.5), spread=0.3))
    cfg = tcornell.full_config().replace(resolution=(48, 48), max_raymarch=64)
    return tcornell.full_scene(CPU), cfg, cornell_primaries(cfg, n=512)


CHAIN_SCHEDULES = {"steps16": (16, 16, 16, 16), "doubling": (8, 8, 16, 32)}


@pytest.mark.parametrize("schedule", sorted(CHAIN_SCHEDULES))
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("family", ["cornell_full_constant_absolute",
                                    "cornell_v3_rollback", "minimal",
                                    "engine_rollback_cone"])
def test_chained_resumes_bit_identical(family, gated, schedule):
    """Chained resumes over even 16-trip steps or the doubling 8+8+16+32
    equal one uninterrupted call with the same gate, lane by lane and bit
    for bit on all eight outputs, ``fin`` summed (the property the split
    wavefront and the megakernel's gate rest on); gated lanes echo their
    init."""
    scene, cfg, (o, d) = _chain_family(family)
    o, d = tt(o), tt(d)
    gate = (tt(np.random.default_rng(5).random(o.shape[0]) < 0.7)
            if gated else None)
    budgets = CHAIN_SCHEDULES[schedule]
    assert sum(budgets) == cfg.max_raymarch
    one = tmarch.march_resumable(scene, o, d, cfg, active=gate)
    got = chained_resumes(scene, o, d, cfg, budgets, gate)
    for name, a, b in zip(tmarch.ResumableResult._fields, got, one):
        assert torch.equal(a, b), name
    # some lanes resume: they outlast the first call
    assert int((one.fin > budgets[0]).sum()) > 0
    if gated:
        off = ~gate
        assert int(off.sum()) > 0
        assert bool((got.t[off] == cfg.march_t0).all())
        assert bool((got.w[off] == cfg.omega).all())
        assert bool((got.fin[off] == 0).all())
        assert not bool(got.hit[off].any())


def test_inactive_lanes_echo_init_and_ragged_n():
    scene = tcornell.full_scene(CPU)
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
    scene = tcornell.full_scene(CPU)
    cfg = tcornell.full_config().replace(max_raymarch=16)
    o, d = random_rays(64, seed=0)
    before = dict(march_kernel.LAUNCHES)
    rr = tmarch.march_resumable(scene, tt(o), tt(d), cfg)
    ref = tmarch.march_resumable_plain(scene, tt(o), tt(d), cfg)
    assert march_kernel.LAUNCHES == before
    for a, b in zip(rr, ref):
        np.testing.assert_array_equal(nn(a), nn(b))


def test_kernel_wrapper_refuses_cpu_and_other_variants():
    scene = tcornell.full_scene(CPU)
    o, d = random_rays(8, seed=0)
    with pytest.raises(ValueError):
        march_kernel.march_resumable_cuda(scene, tt(o), tt(d),
                                          tcornell.full_config())
    # cfg.bunny_mxu selects the tensor-core bunny MLP, K1d, and K1d too
    # refuses CPU tensors
    glass, gcfg = tbunny.glass_scene(CPU), tbunny.glass_config()
    assert march_kernel.variant(glass, gcfg) == "k1c"
    assert march_kernel.variant(glass, gcfg.replace(bunny_mxu=True)) == "k1d"
    with pytest.raises(ValueError):
        march_kernel.march_resumable_cuda(glass, tt(o), tt(d),
                                          gcfg.replace(bunny_mxu=True))
    assert march_kernel.variant(scene, tcornell.full_config()) == "k1a"
    assert march_kernel.variant(scene, tcornell.v3_config()) == "k1b"
    # march(differentiable=True), the reference's default, no longer
    # raises: on CPU tensors the plain march's t, with the hit-point
    # gradient attached where autograd records
    cfg = tcornell.full_config()
    got = tmarch.march(scene, tt(o), tt(d), cfg, differentiable=True)
    plain = tmarch.march_resumable(scene, tt(o), tt(d), cfg)
    assert torch.equal(got.t, plain.t) and torch.equal(got.hit, plain.hit)


def test_pack_scene_layout():
    scene = tcornell.full_scene(CPU)
    p = nn(march_kernel.pack_scene(scene))
    assert p.shape == (scene.num_objects, 32)
    np.testing.assert_array_equal(p[:, 0:3], nn(scene.position))
    np.testing.assert_array_equal(p[:, 3:6], nn(scene.scale))
    np.testing.assert_array_equal(p[:, 6:15],
                                  nn(scene.matrix).reshape(-1, 9))
    np.testing.assert_array_equal(p[:, 15:18], nn(scene.local_offset))
    assert (p[:, 18:] == 0).all()


def _count_packs(monkeypatch):
    """Counts the calls of the functions the kernels' packs come from."""
    calls = {}
    for mod, name in ((march_kernel, "pack_scene"),
                      (march_kernel, "pack_bunny"),
                      (march_kernel, "pack_bunny_mxu"),
                      (march_kernel.scenelib, "escape_bound2")):
        calls[name] = 0

        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("kind", ["k1c", "k1d"])
def test_scene_packs_once_per_scene(monkeypatch, kind):
    """A frame's four calls on one scene share one set of packs; the
    boundless config packs apart, and a buffer the scene replaces or one
    changed in place packs anew."""
    calls = _count_packs(monkeypatch)
    scene = tbunny.glass_scene(CPU)
    cfg = tbunny.glass_config().replace(escape_bound=True,
                                        bunny_mxu=kind == "k1d")
    assert march_kernel.variant(scene, cfg) == kind
    first = march_kernel.scene_packs(scene, kind, cfg)
    for _ in range(3):
        again = march_kernel.scene_packs(scene, kind, cfg)
        assert all(a is b for a, b in zip(first, again))
    assert calls == {"pack_scene": 1, "pack_bunny": int(kind == "k1c"),
                     "pack_bunny_mxu": int(kind == "k1d"),
                     "escape_bound2": 1}
    bound2, params, bunny = first
    assert params.is_contiguous() and bunny.is_contiguous()
    direct_pack = (march_kernel.pack_bunny if kind == "k1c"
                   else march_kernel.pack_bunny_mxu)
    assert torch.equal(bunny, direct_pack(scene))
    assert torch.equal(params, march_kernel.pack_scene(scene, bound2))
    assert float(params[0, 18]) == float(bound2) > 0.0
    calls["pack_scene"] = 0

    free = march_kernel.scene_packs(scene, kind,
                                    cfg.replace(escape_bound=False))
    assert free[0] is None and float(free[1][0, 18]) == 0.0
    assert march_kernel.scene_packs(scene, kind, cfg)[1] is params
    scene.position = scene.position + 0.25  # as scene.to() replaces it
    moved = march_kernel.scene_packs(scene, kind, cfg)
    assert moved[1] is not params
    assert torch.equal(moved[1][:, 0:3], scene.position)
    assert calls["pack_scene"] == 2
    scene.position.add_(0.5)  # in place: the same tensor, a new version
    shifted = march_kernel.scene_packs(scene, kind, cfg)
    assert torch.equal(shifted[1][:, 0:3], scene.position)
    assert calls["pack_scene"] == 3
    scene.bunny.w_in.mul_(2.0)
    doubled = march_kernel.scene_packs(scene, kind, cfg)[2]
    assert torch.equal(doubled, direct_pack(scene))
    assert not torch.equal(doubled, bunny)
    assert calls["pack_scene"] == 4


def test_animated_scene_gets_fresh_packs():
    """``animate`` to another frame is a new scene: its packs are its own
    and equal a direct packing of it."""
    from raytracingpbr_tpu_torch.ops import scene as tscenelib
    base = tbunny.glass_scene(CPU)
    cfg = tbunny.glass_config()
    s12 = tscenelib.animate(base, 12.0)
    p12 = march_kernel.scene_packs(s12, "k1c", cfg)
    s13 = tscenelib.animate(base, 13.0)
    for kind, pack in (("k1c", march_kernel.pack_bunny),
                       ("k1d", march_kernel.pack_bunny_mxu)):
        bound2, params, bunny = march_kernel.scene_packs(s13, kind, cfg)
        assert bound2 is None
        assert torch.equal(params, march_kernel.pack_scene(s13))
        assert torch.equal(bunny, pack(s13))
    assert not torch.equal(params, p12[1])  # the spin moved the matrix
    assert torch.equal(march_kernel.scene_packs(s12, "k1c", cfg)[1], p12[1])
