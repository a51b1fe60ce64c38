"""The third slice on the CPU: the bunny march with ``cfg.bunny_mxu``
(kernel K1d's path) against the JAX package.

* ``pack_bunny_mxu`` unpacks to the ``BunnyMLP`` it came from: every
  weight in its fragment slot, each hidden weight as a TF32 pair whose sum
  is the weight to the split's precision.
* The port's plain K1d march (the MLP in the matmul form) against JAX's
  ``march_pallas(cfg.bunny_mxu=True)``, the TPU kernel in interpret mode,
  at ``tests/test_pallas.py``'s bars (at least 99.9% hit agreement, t
  within rtol 1e-3 on agreeing lanes, equal index where both hit): one
  unsplit march, and a gated, resumed chain through
  ``march_resumable(backend="pallas")``.
* The bar K1d is held to on the card (``ops/march.assert_march_close``)
  on hand-made results: what it excuses and what it refuses.
* One metal-bunny ``render_frame`` with ``bunny_mxu`` from a converted
  mid-flight state against JAX, at the glass slice's bar
  (``tests/test_torch_slice_bunny.py``): counters exact, at least
  99% of lanes within rtol 1e-4.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu.pallas import march_kernel as jkernel
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.kernels import march_kernel
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.ops import integrator as tinteg
from raytracingpbr_tpu_torch.ops import march as tmarch

from .test_torch_march import _assert_march_bars
from .test_torch_march_variants import bunny_rays
from .test_torch_slice import _jax_leaves, _lanes_close
from .torch_helpers import CPU, nn, tt


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _is_tf32(v: np.ndarray) -> bool:
    return bool((v.astype(np.float32).view(np.int32) & 0x1FFF == 0).all())


def test_pack_bunny_mxu_unpacks_to_its_mlp():
    scene = tbunny.glass_scene(CPU)
    mlp = {k: nn(v).astype(np.float64) for k, v in scene.bunny._asdict()
           .items()}
    pack = nn(march_kernel.pack_bunny_mxu(scene))
    assert pack.shape == (64, 32) and pack.dtype == np.float32
    w_in, b_in, w_out = (np.full(s, np.nan) for s in ((3, 16), 16, 16))
    hidden = [(np.full((16, 16), np.nan), np.full(16, np.nan))
              for _ in range(2)]
    for lane in range(32):
        g, t = divmod(lane, 4)
        for q in range(4):
            f = 8 * (q // 2) + 2 * t + q % 2
            w_in[:, f] = pack[4 * q:4 * q + 3, lane]
            b_in[f] = pack[4 * q + 3, lane]
            w_out[f] = pack[56 + q, lane]
            for h in range(2):
                hidden[h][1][f] = pack[32 + 20 * h + q, lane]
        for h in range(2):
            for m in range(4):
                kk, nt = divmod(m, 2)
                r = 16 + 20 * h + 4 * m
                for j in range(2):
                    big, small = pack[r + j, lane], pack[r + 2 + j, lane]
                    assert _is_tf32(np.array([big, small]))
                    hidden[h][0][8 * kk + 2 * t + j, 8 * nt + g] = (
                        np.float64(big) + np.float64(small))
    np.testing.assert_array_equal(w_in, mlp["w_in"])
    np.testing.assert_array_equal(b_in, mlp["b_in"])
    np.testing.assert_array_equal(w_out, mlp["w_out"])
    for h, name in enumerate(("h1", "h2")):
        np.testing.assert_array_equal(hidden[h][1], mlp[f"b_{name}"])
        # big + small holds the weight to about 2^-21 of its size
        np.testing.assert_allclose(hidden[h][0], mlp[f"w_{name}"],
                                   rtol=2.0 ** -20, atol=0)
    assert (pack[60] == np.float32(mlp["bias_out"])).all()
    assert (pack[61:] == 0).all()


def test_plain_k1d_march_matches_pallas_interpret(interpret):
    js = jbunny.glass_scene()
    jcfg = jbunny.glass_config(scale=8).replace(max_raymarch=64,
                                                 bunny_mxu=True)
    o, d = bunny_rays(n=2048, seed=11)
    t, idx, hit, _ = jkernel.march_pallas(js, jnp.asarray(o),
                                          jnp.asarray(d), jcfg)
    ref = types.SimpleNamespace(t=t, index=idx, hit=hit)
    ts, tcfg = convert.scene_from_jax(js, CPU), convert.config_from_jax(jcfg)
    assert march_kernel.variant(ts, tcfg) == "k1d"
    got = tmarch.march(ts, tt(o), tt(d), tcfg)
    _assert_march_bars(ref, got)
    assert nn(got.hit).mean() > 0.2


def test_plain_k1d_resumed_chain_matches_pallas_interpret(interpret):
    """Two gated budget-8 calls on the metal bunny, the second resuming
    from the first's (JAX) loop state, each against the TPU kernel's
    resume path."""
    js = jbunny.metal_scene()
    jcfg = jbunny.metal_config(scale=8).replace(max_raymarch=8,
                                                 bunny_mxu=True)
    ts, tcfg = convert.scene_from_jax(js, CPU), convert.config_from_jax(jcfg)
    o, d = bunny_rays(n=1024, seed=12)
    n = o.shape[0]
    rng = np.random.default_rng(12)
    active = rng.random(n) < 0.8
    init = (rng.uniform(0.005, 1.2, n).astype(np.float32),
            np.full(n, 0.9, np.float32),
            rng.uniform(0, 0.1, n).astype(np.float32),
            np.full(n, 1e3, np.float32))
    for _ in range(2):
        ref = jmarch.march_resumable(js, jnp.asarray(o), jnp.asarray(d),
                                     jcfg, active=jnp.asarray(active),
                                     init=tuple(jnp.asarray(v)
                                                for v in init),
                                     backend="pallas")
        got = tmarch.march_resumable(ts, tt(o), tt(d), tcfg,
                                     active=tt(active),
                                     init=tuple(tt(v) for v in init))
        _assert_march_bars(ref, got)
        agree = np.asarray(ref.hit) == nn(got.hit)
        for k in ("fin", "done"):
            np.testing.assert_array_equal(
                nn(getattr(got, k))[agree],
                np.asarray(getattr(ref, k))[agree])
        active = active & (np.asarray(ref.done) == 0)
        init = tuple(np.asarray(getattr(ref, k)) for k in "twsd")
    assert active.any()  # the second call resumed live lanes


def _bar_case(case):
    """Two hand-made march results of 20,000 rays on the metal bunny from
    (0, 0, 5) towards it (RELATIVE hit at 480x270: pixel radius 1/480),
    even lanes hits, that differ as ``case`` says. The bar lets 20 lanes
    split on hit and 2 part in t."""
    scene = tbunny.metal_scene(CPU)
    cfg = tbunny.metal_config().replace(resolution=(480, 270))
    n = 20000
    o = torch.tensor([0.0, 0.0, 5.0]).expand(n, 3)
    d = torch.tensor([0.0, 0.0, -1.0]).repeat(n, 1)
    t = torch.linspace(1.0, 5.0, n)
    hit = torch.arange(n) % 2 == 0
    index = torch.where(hit, 3, 0).to(torch.int32)
    zeros = torch.zeros(n)
    k = tmarch.ResumableResult(t, index, hit, torch.ones(n, dtype=torch.int32),
                               zeros, zeros, zeros,
                               torch.ones(n, dtype=torch.int32))
    p = k._replace(t=t.clone(), hit=hit.clone(), index=index.clone())
    what, _, count = case.partition("_x")
    count = int(count or 0)
    if what == "escaped_overshoot":      # excused: both past max_dis
        k.t[1], p.t[1] = 1129.0, 1877.0
    elif what == "escaping_apart":       # excused: both left the bound
        d[1] = -d[1]
        k.t[1], p.t[1] = 30.5098, 30.5555
    elif what == "hits_one_trip_apart":  # excused: within one tolerance
        k.t[0], p.t[0] = 2.8625, 2.8676
    elif what == "hit_splits":
        p.hit[0:2 * count:2] = False
    elif what == "misses_apart":
        p.t[1:2 * count:2] += 0.05
    elif what == "hits_apart":
        p.t[0:2 * count:2] += 0.05
    elif what == "index_where_both_hit":
        p.index[2] = 4
    return scene, o, d, k, p, cfg


@pytest.mark.parametrize("case,excused,split,apart", [
    ("equal", 0, 0, 0), ("escaped_overshoot", 1, 0, 0),
    ("escaping_apart", 1, 0, 0), ("hits_one_trip_apart", 1, 0, 0),
    ("hit_splits_x20", 0, 20, 0), ("misses_apart_x2", 0, 0, 2),
    ("hits_apart_x2", 0, 0, 2)])
def test_march_bar_passes(case, excused, split, apart):
    err, n_excused, n_split, mask = tmarch.assert_march_close(
        *_bar_case(case))
    assert (n_excused, n_split, int(mask.sum())) == (excused, split, apart)
    assert err == 0.0


@pytest.mark.parametrize("case", [
    "hits_apart_x3", "misses_apart_x3", "hit_splits_x21",
    "index_where_both_hit"])
def test_march_bar_fails(case):
    with pytest.raises(AssertionError, match="march bar"):
        tmarch.assert_march_close(*_bar_case(case))


JCFG = jbunny.metal_config().replace(
    resolution=(24, 14), max_raytrace=8, samples_per_frame=4,
    samples_per_pixel=1, bunny_mxu=True)


def test_metal_render_frame_mxu_matches_jax_from_converted_state():
    scene = jbunny.metal_scene()
    env = jbunny.glass_environment()
    cam = jbunny.camera(JCFG.width / JCFG.height)
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st,
                                                   JCFG))
    _, mid = frame(j_make_state(JCFG.num_pixels))
    j_px, j_next = frame(mid)
    assert int(np.asarray(mid.march_cum).max()) > 0  # segments in flight
    t_px, t_next = tinteg.render_frame(
        tbunny.metal_scene(CPU), tbunny.glass_environment(device=CPU),
        tbunny.camera(JCFG.width / JCFG.height, CPU),
        convert.frame_state_from_jax(mid, CPU), convert.config_from_jax(JCFG))
    got = convert.frame_state_to_numpy(t_next)
    ref = _jax_leaves(j_next)
    assert got["frame"] == ref["frame"]
    np.testing.assert_array_equal(got["respawn"], ref["respawn"])
    for k in ("rays.origin", "rays.direction", "rays.color", "rays.depth",
              "accum", "march_state", "march_cum", "hit_t"):
        frac = _lanes_close(got[k], ref[k]).mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"
    frac = _lanes_close(nn(t_px), np.asarray(j_px)).mean()
    assert frac >= 0.99, f"pixels: only {frac:.2%} of lanes agree"
    assert (ref["hit_t"] < 1e9).any()  # primary rays found the bunny
