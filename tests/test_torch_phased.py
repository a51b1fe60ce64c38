"""The phased (compacted) march of the port (``ops/march.march_phased``)
against the JAX package's ``march_phased``, run in interpret mode as
``tests/test_pallas.py`` runs it, and against the port's own unphased
march; ``resolve_phases``, the partition and ``phased_executed``.

Bars: within the port, the phased march equals the unphased one bit for
bit on all eight outputs (per lane the trips are those of one march).
Against JAX's Pallas kernel on these rays: index, hit and fin equal on
every lane, t within ``tests/test_pallas.py``'s rtol and atol 1e-3 (the
two frameworks round the march's arithmetic differently in the last ulp).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.pallas import march_kernel as mk
from raytracingpbr_tpu_torch.convert import config_from_jax, scene_from_jax
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import compact as tcompact
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.utils import speedlight

from .torch_helpers import CPU, nn, random_rays, tt

N_RAYS = 777  # not a multiple of the TPU tile: JAX pads, the port does not


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (no TPU here)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _family(family):
    if family == "minimal":
        return (jcornell.minimal_scene(),
                jcornell.minimal_config().replace(max_raymarch=256))
    return jdemo.engine_scene(), jdemo.engine_config().replace(
        max_raymarch=128)


def _gate(use_active):
    if not use_active:
        return None
    return np.random.default_rng(1).random(N_RAYS) < 0.7


@pytest.mark.parametrize("use_active", [False, True])
@pytest.mark.parametrize("family", ["minimal", "engine"])
def test_phased_march_matches_jax(interpret_mode, family, use_active):
    """``tests/test_pallas.py::test_phased_march_bit_equal``'s cases: the
    port's phased march against JAX's on the same 777 rays."""
    jscene, jcfg = _family(family)
    assert len(mk.resolve_phases(jcfg)) > 1
    o, d = random_rays(N_RAYS, 0)
    gate = _gate(use_active)
    jt, ji, jh, jf = mk.march_phased(
        jscene, jnp.asarray(o), jnp.asarray(d), jcfg,
        active=None if gate is None else jnp.asarray(gate))
    got = tmarch.march_phased(scene_from_jax(jscene, CPU), tt(o), tt(d),
                              config_from_jax(jcfg),
                              active=None if gate is None else tt(gate))
    np.testing.assert_array_equal(nn(got.hit), np.asarray(jh))
    np.testing.assert_array_equal(nn(got.index), np.asarray(ji))
    np.testing.assert_array_equal(nn(got.fin), np.asarray(jf))
    np.testing.assert_allclose(nn(got.t), np.asarray(jt), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("use_active", [False, True])
@pytest.mark.parametrize("family", ["minimal", "engine"])
def test_phased_march_equals_unphased(family, use_active):
    """All eight outputs bit-equal, gated lanes included; ``march()``
    takes the phased path under ``cfg.march_compaction`` with the same
    results."""
    jscene, jcfg = _family(family)
    scene, cfg = scene_from_jax(jscene, CPU), config_from_jax(jcfg)
    o, d = (tt(v) for v in random_rays(N_RAYS, 0))
    gate = _gate(use_active)
    gate = None if gate is None else tt(gate)
    one = tmarch.march_resumable(scene, o, d, cfg, active=gate)
    phased = tmarch.march_phased(scene, o, d, cfg, active=gate)
    for name, a, b in zip(tmarch.ResumableResult._fields, phased, one):
        assert torch.equal(a, b), name
    # the phased march really repartitions: some lanes outlast a phase
    assert int((one.fin > tmarch.resolve_phases(cfg)[0]).sum()) > 0
    ref = tmarch.march(scene, o, d, cfg, differentiable=False, active=gate)
    got = tmarch.march(scene, o, d, cfg.replace(march_compaction=True),
                       differentiable=False, active=gate)
    for name in ("t", "position", "index", "hit", "iters"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_phased_march_resumes_from_init():
    """A phased march resumed from a carried state equals the unphased
    resume (the init of the first phase)."""
    scene = tcornell.minimal_scene(CPU)
    cfg = tcornell.minimal_config().replace(max_raymarch=128)
    o, d = (tt(v) for v in random_rays(N_RAYS, 2))
    first = tmarch.march_resumable(scene, o, d, cfg.replace(max_raymarch=5))
    init = (first.t, first.w, first.s, first.d)
    live = first.done == 0
    one = tmarch.march_resumable(scene, o, d, cfg, active=live, init=init)
    phased = tmarch.march_phased(scene, o, d, cfg, active=live, init=init)
    for name, a, b in zip(tmarch.ResumableResult._fields, phased, one):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", [
    dict(max_raymarch=64), dict(max_raymarch=512), dict(max_raymarch=2048),
    dict(max_raymarch=100), dict(max_raymarch=512, march_phases=(256, 256)),
    dict(max_raymarch=512, march_chunk=64), dict(max_raymarch=32)])
def test_resolve_phases_matches_jax(case):
    jcfg = jcornell.minimal_config().replace(**case)
    assert tmarch.resolve_phases(config_from_jax(jcfg)) == \
        mk.resolve_phases(jcfg)


def test_resolve_phases_refuses_a_bad_split():
    base = tcornell.minimal_config().replace(max_raymarch=512)
    assert tmarch.resolve_phases(base.replace(march_phases=(256, 256))) == \
        (256, 256)
    for bad in ((256, 128), (512, 0)):
        with pytest.raises(ValueError):
            tmarch.resolve_phases(base.replace(march_phases=bad))
        with pytest.raises(ValueError):
            mk.resolve_phases(jcornell.minimal_config().replace(
                max_raymarch=512, march_phases=bad))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_active_matches_jax(seed):
    """JAX's ``_partition_active(done)`` is the port's
    ``actives_first_perm`` of the lanes not done."""
    done = np.random.default_rng(seed).random(1000) < 0.6
    ref = np.asarray(mk._partition_active(jnp.asarray(done, jnp.int32)))
    got = nn(tcompact.actives_first_perm(tt(~done)))
    np.testing.assert_array_equal(got, ref)
    assert nn(tcompact.actives_first_perm(tt([False, True, False, True, True,
                                             False, True]))).tolist() \
        == [1, 3, 4, 6, 0, 2, 5]


def _brute_phased_executed(fin, phases):
    """Lane-trips of the phased march by direct simulation: the lanes'
    positions permuted phase by phase by an explicit stable sort, each
    warp of 32 positions charged 32 times its longest lane's trips."""
    fin = np.asarray(fin, np.int64)
    order = np.arange(fin.size)
    done_trips = np.zeros_like(fin)
    total = 0
    for k, b in enumerate(phases):
        if k > 0:
            going = done_trips[order] < fin[order]
            order = np.concatenate([order[going], order[~going]])
        trips = np.minimum(fin[order] - done_trips[order], b)
        pad = np.concatenate([trips, np.zeros((-trips.size) % 32, np.int64)])
        total += int(pad.reshape(-1, 32).max(axis=1).sum()) * 32
        done_trips[order] += trips
    return total


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_phased_executed_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    phases = (32, 32, 64, 128, 256)
    # a long-tailed need with gated (0) and unconverged (512) lanes
    fin = np.minimum(rng.geometric(0.05, n), 512)
    fin[rng.random(n) < 0.2] = 0
    fin[rng.random(n) < 0.01] = 512
    got = speedlight.phased_executed(torch.as_tensor(fin), phases)
    assert got == _brute_phased_executed(fin, phases)
    # the one-phase schedule is the unphased march's warps
    assert speedlight.phased_executed(torch.as_tensor(fin), (512,)) == \
        speedlight.warp_executed(torch.as_tensor(fin))


def test_render_image_with_compaction_is_bit_identical():
    """The megakernel (its march and the escape checks on the CPU) renders
    the same bits with the phased march."""
    cfg = tcornell.full_config().replace(resolution=(12, 12),
                                         max_raymarch=256, max_raytrace=6)
    args = (tcornell.full_scene(CPU), tcornell.sky(CPU),
            tcornell.full_camera(CPU))
    ref = tinteg.render_image(*args, cfg, spp=2, tonemapped=False)
    got = tinteg.render_image(*args, cfg.replace(march_compaction=True),
                              spp=2, tonemapped=False)
    assert torch.equal(got, ref)
