"""The port's sharded renderer and train step (``parallel/mesh``,
``parallel/render``, ``parallel/scaling``, ``parallel/train``) on the CPU,
every rank of a mesh in this one process: every test of
``tests/test_parallel.py`` on the port, on the minimal Cornell box at
16x16, and the port against the JAX package on its own 8-device mesh
(the conftest's virtual CPU devices).

Within the port, a tiles-only mesh renders ``render_image`` /
``render_frame``'s bits under either layout, reprojection and the
adaptive gate included; a mesh with sample ranks is held to
``tests/test_parallel.py``'s atol 1e-5 / rtol 1e-4 (its partial sums are
added in another order). Against JAX: stills at
``tests/test_torch_megakernel.py``'s image bar, a frame from a converted
sharded state at ``tests/test_torch_wavefront.py``'s lane bar (rtol 1e-4
on 99% of lanes), three train steps at ``tests/test_torch_train.py``'s
rtol 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.ops.scene import ObjectSpec as JSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu.parallel import mesh as jmesh
from raytracingpbr_tpu.parallel import render as jrender
from raytracingpbr_tpu.parallel import train as jtrain
import raytracingpbr_tpu_torch as tr
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.models import cornell
from raytracingpbr_tpu_torch.ops import integrator as integ
from raytracingpbr_tpu_torch.ops.scene import ObjectSpec
from raytracingpbr_tpu_torch.ops.sdf import SHAPE
from raytracingpbr_tpu_torch.parallel import mesh as meshlib
from raytracingpbr_tpu_torch.parallel import render as prender
from raytracingpbr_tpu_torch.parallel import scaling
from raytracingpbr_tpu_torch.parallel import train as ptrain

from .test_torch_megakernel import assert_image_bar
from .torch_helpers import CPU, nn, tt

JCFG = jcornell.minimal_config().replace(resolution=(16, 16),
                                         max_raymarch=64)
CFG = convert.config_from_jax(JCFG)


@pytest.fixture(scope="module")
def setup():
    return (cornell.minimal_scene(CPU), cornell.sky(CPU),
            cornell.minimal_camera(CPU), CFG)


def frames(fn, state, count):
    px = None
    for _ in range(count):
        px, state = fn(state)
    return px, state


def test_mesh_lays_ranks_row_major():
    """A one-process mesh holds every rank; rank r is (r // samples,
    r % samples); each process's block covers whole tiles."""
    m = meshlib.make_mesh(tiles=4, samples=2)
    assert (m.tiles, m.samples, m.group, m.world, m.rank) == (4, 2, None,
                                                              1, 0)
    assert m.shape == {meshlib.TILE_AXIS: 4, meshlib.SAMPLE_AXIS: 2}
    assert list(m.local_ranks()) == list(range(8))
    assert [m.coords(r) for r in (0, 1, 5, 7)] == [(0, 0), (0, 1), (2, 1),
                                                   (3, 1)]
    assert m.local_tiles() == [0, 1, 2, 3]
    assert meshlib.make_mesh().size == 1  # every process on the tile axis
    assert meshlib.make_mesh(samples=1, tiles=8).local_tiles() == list(
        range(8))
    assert meshlib.pad_to_multiple(17, 8) == 24
    meshlib.multihost_init(None, 1, 0)  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0)
    assert meshlib.all_gather_rows(m, x) is x  # no group: this process


@pytest.mark.parametrize("tiles,samples,layout", [
    (8, 1, "contiguous"), (8, 1, "strided"), (4, 2, "contiguous"),
    (2, 4, "contiguous")])
def test_sharded_image_matches_single_device(setup, tiles, samples, layout):
    """Tiles-only meshes give ``render_image``'s bits under both layouts;
    sample meshes are within ``tests/test_parallel.py``'s bar."""
    scene, env, cam, cfg = setup
    single = integ.render_image(scene, env, cam, cfg, spp=4,
                                tonemapped=False)
    mesh = meshlib.make_mesh(tiles=tiles, samples=samples)
    sharded = prender.render_image_sharded(scene, env, cam, cfg, mesh, spp=4,
                                           tonemapped=False, layout=layout)
    if samples == 1:
        assert torch.equal(sharded, single)
    np.testing.assert_allclose(nn(sharded), nn(single), atol=1e-5, rtol=1e-4)
    # tonemapped, as render_image tonemaps
    toned = prender.render_image_sharded(scene, env, cam, cfg, mesh, spp=4,
                                         layout=layout)
    np.testing.assert_allclose(
        nn(toned), nn(integ.render_image(scene, env, cam, cfg, spp=4)),
        atol=1e-5, rtol=1e-4)


def test_sharded_wavefront_matches_single_device(setup):
    """Three frames on the (8, 1) mesh: pixels and accumulator bit for bit
    ``render_frame``'s."""
    scene, env, cam, cfg = setup
    cfg = cfg.replace(samples_per_frame=2, max_raytrace=512,
                      quality_per_sample=0.8)
    n = cfg.num_pixels
    px_s, state_s = frames(lambda st: integ.render_frame(
        scene, env, cam, st, cfg), make_frame_state(n, CPU), 3)
    mesh = meshlib.make_mesh(tiles=8, samples=1)
    px_m, state_m = frames(lambda st: prender.render_frame_sharded(
        scene, env, cam, st, cfg, mesh), prender.shard_frame_state(
            make_frame_state(n, CPU), mesh), 3)
    assert torch.equal(px_m, px_s)
    assert torch.equal(state_m.accum, state_s.accum)
    assert torch.equal(prender.gather_image(px_m, cfg, mesh),
                       prender.gather_image(px_s, cfg))


def test_strided_layout_matches_single_device(setup):
    """The strided layout renders the same still and frames; the frame
    state lives in (tile, slot) order, ``unshard_pixels`` and
    ``gather_image`` invert it."""
    scene, env, cam, cfg = setup
    mesh = meshlib.make_mesh(tiles=8, samples=1)
    single = integ.render_image(scene, env, cam, cfg, spp=4,
                                tonemapped=False)
    strided = prender.render_image_sharded(scene, env, cam, cfg, mesh,
                                           spp=4, tonemapped=False,
                                           layout="strided")
    assert torch.equal(strided, single)

    cfg2 = cfg.replace(samples_per_frame=2)
    n = cfg2.num_pixels
    px_s, state_s = frames(lambda st: integ.render_frame(
        scene, env, cam, st, cfg2), make_frame_state(n, CPU), 3)
    px_m, state_m = frames(lambda st: prender.render_frame_sharded(
        scene, env, cam, st, cfg2, mesh, layout="strided"),
        prender.shard_frame_state(make_frame_state(n, CPU), mesh,
                                  "strided"), 3)
    assert not torch.equal(px_m, px_s)  # the rows are permuted
    assert torch.equal(prender.unshard_pixels(px_m, 8, "strided"), px_s)
    assert torch.equal(prender.unshard_pixels(state_m.accum, 8, "strided"),
                       state_s.accum)
    assert torch.equal(prender.gather_image(px_m, cfg2, mesh, "strided"),
                       prender.gather_image(px_s, cfg2))


def test_scaling_report_harness(setup):
    """The per-tile scaling report runs, accounts every tile and marks a
    mesh of more ranks than cards virtual."""
    scene, env, cam, cfg = setup
    for layout in ("contiguous", "strided"):
        mesh = meshlib.make_mesh(tiles=8, samples=1)
        rep = scaling.measure(scene, env, cam, cfg, mesh, iters=1,
                              layout=layout)
        assert rep.n_tiles == 8 and len(rep.tiles) == 8
        assert rep.virtual  # the CPU: no card at all
        assert np.isfinite(rep.imbalance_pct) and rep.imbalance_pct >= 0
        assert all(t.seconds > 0 and t.march_iters > 0 for t in rep.tiles)
        assert rep.t_single > 0 and rep.t_sharded > 0
        table = rep.table()
        assert "| tile |" in table and "efficiency not meaningful" in table
        assert table.count("\n| ") == 8  # a row a tile


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_sharded_reprojection_matches_single_device(setup, layout):
    """``cfg.reprojection`` under the mesh: 3 frames, a move, a
    reprojected refresh; the warp gathers the state into image order (the
    strided rows permuted there and back), so pixels and accumulator are
    ``render_frame(prev_cam=...)``'s bit for bit (``index_add_`` adds in
    lane order on the CPU)."""
    scene, env, cam, cfg = setup
    cfg = cfg.replace(samples_per_frame=2, reprojection=True)
    n = cfg.num_pixels
    cam2 = dataclasses.replace(cam, lookfrom=cam.lookfrom
                               + torch.tensor([0.08, 0.0, 0.0]))

    _, state_s = frames(lambda st: integ.render_frame(
        scene, env, cam, st, cfg), make_frame_state(n, CPU), 3)
    px_s, state_s = integ.render_frame(scene, env, cam2, state_s, cfg,
                                       refreshing=True, prev_cam=cam)

    mesh = meshlib.make_mesh(tiles=8, samples=1)
    _, state_m = frames(lambda st: prender.render_frame_sharded(
        scene, env, cam, st, cfg, mesh, layout=layout),
        prender.shard_frame_state(make_frame_state(n, CPU), mesh, layout), 3)
    px_m, state_m = prender.render_frame_sharded(
        scene, env, cam2, state_m, cfg, mesh, refreshing=True, prev_cam=cam,
        layout=layout)
    assert torch.equal(prender.unshard_pixels(px_m, 8, layout), px_s)
    assert torch.equal(prender.unshard_pixels(state_m.accum, 8, layout),
                       state_s.accum)
    assert torch.equal(prender.unshard_pixels(state_m.hit_t, 8, layout),
                       state_s.hit_t)


def test_shard_unshard_roundtrip():
    """``shard_pixels`` is the exact inverse of ``unshard_pixels``; row
    ``ti*per + k`` of the sharded layout holds pixel ``ti + k*tiles``."""
    x = torch.arange(48.0).reshape(24, 2)
    y = prender.shard_pixels(x, 8, "strided")
    assert torch.equal(prender.unshard_pixels(y, 8, "strided"), x)
    np.testing.assert_array_equal((nn(y[:, 0]).astype(int) // 2) % 8,
                                  np.repeat(np.arange(8), 3))
    ids = torch.cat([prender.tile_pixel_ids(ti, 24, 8, "strided")
                     for ti in range(8)])
    assert torch.equal(ids, prender.shard_pixels(torch.arange(24), 8,
                                                 "strided"))
    assert prender.shard_pixels(x, 8, "contiguous") is x


def test_sharded_adaptive_sampling_matches_single_device(setup):
    """``cfg.adaptive_sampling`` under the mesh: the gate is elementwise,
    so the sharded frames (strided) are ``render_frame``'s bit for bit,
    the set of stopped pixels included."""
    scene, env, cam, cfg = setup
    cfg = cfg.replace(samples_per_frame=2, adaptive_sampling=True,
                      noise_threshold=0.1)
    n = cfg.num_pixels
    px_s, state_s = frames(lambda st: integ.render_frame(
        scene, env, cam, st, cfg), make_frame_state(n, CPU), 10)
    mesh = meshlib.make_mesh(tiles=8, samples=1)
    px_m, state_m = frames(lambda st: prender.render_frame_sharded(
        scene, env, cam, st, cfg, mesh, layout="strided"),
        prender.shard_frame_state(make_frame_state(n, CPU), mesh,
                                  "strided"), 10)
    stopped = nn(state_s.noise) <= cfg.noise_threshold
    assert stopped.any(), "noise gate never engaged"
    un = lambda x: prender.unshard_pixels(x, 8, "strided")
    assert torch.equal(un(px_m), px_s)
    assert torch.equal(un(state_m.accum), state_s.accum)
    np.testing.assert_array_equal(nn(un(state_m.noise)) <= cfg.noise_threshold,
                                  stopped)


# --- the train step ---------------------------------------------------------

TRAIN_JCFG = rt.RenderConfig(
    resolution=(16, 16), max_raymarch=48, max_raytrace=4, light_quality=1e9,
    roulette=rt.Roulette.EXP, omega=1.0,
    omega_policy=rt.OmegaPolicy.CONSTANT,
    hit_criterion=rt.HitCriterion.ABSOLUTE, hit_precision=1e-4,
    march_t0=0.005, max_dis=100.0)
TRAIN_CFG = convert.config_from_jax(TRAIN_JCFG)


def sphere(albedo):
    return tr.make_scene([ObjectSpec(SHAPE.SPHERE, position=(0, 0, 0),
                                     scale=(1, 1, 1), albedo=albedo,
                                     roughness=1.0)], device=CPU)


def sphere_camera():
    return tr.make_camera(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=40.0,
                          aspect=1.0, aperture=0.0, focus=1.0, device=CPU)


class TestDistributedTraining:
    def test_albedo_recovery(self):
        """``tests/test_parallel.py``'s fit on the (4, 2) mesh: 30 steps of
        Adam under the cosine schedule, albedo only; the loss falls below
        0.2x and the albedo comes within 0.1 of the truth."""
        cfg, env, cam = TRAIN_CFG, tr.white_sky(device=CPU), sphere_camera()
        target = ptrain.render_pixels(
            sphere((0.2, 0.6, 0.8)), env, cam, torch.arange(cfg.num_pixels),
            cfg, spp=8, sample_offset=10_000, differentiable=False)
        step = ptrain.make_sharded_train_step(
            env, cam, cfg, meshlib.make_mesh(tiles=4, samples=2), spp=2,
            param_filter=ptrain.albedo_only_filter)
        ts = ptrain.make_train_state(
            sphere((0.5, 0.5, 0.5)),
            ptrain.adam(ptrain.cosine_decay_schedule(0.08, 30, alpha=0.05)))
        losses = []
        for _ in range(30):
            ts, loss = step(ts, target)
            losses.append(float(loss))
        assert np.mean(losses[-3:]) < losses[0] * 0.2
        np.testing.assert_allclose(nn(ts.scene.albedo)[0], [0.2, 0.6, 0.8],
                                   atol=0.1)

    def test_gradients_identical_across_layouts(self):
        """The averaged gradient does not depend on the tile layout: (8, 1)
        draws the 1 x 1 mesh's sample ids, so its gradient and loss equal
        the one-rank step's to rounding; (2, 4) splits the sample ids, so
        its loss is close."""
        cfg = TRAIN_CFG.replace(resolution=(8, 8), max_raymarch=32,
                                max_raytrace=2)
        env, cam = tr.white_sky(device=CPU), sphere_camera()
        target = torch.zeros((cfg.num_pixels, 3))
        out = {}
        for shape in [(1, 1), (8, 1), (2, 4)]:
            step = ptrain.make_sharded_train_step(
                env, cam, cfg, meshlib.make_mesh(*shape), spp=1)
            ts = ptrain.make_train_state(sphere((0.5, 0.5, 0.5)),
                                         ptrain.adam(1e-3))
            ts2, loss = step(ts, target)
            out[shape] = (float(loss), nn(ts2.scene.albedo))
        np.testing.assert_allclose(out[(8, 1)][0], out[(1, 1)][0], rtol=1e-5)
        np.testing.assert_allclose(out[(8, 1)][1], out[(1, 1)][1], rtol=1e-6)
        assert abs(out[(8, 1)][0] - out[(2, 4)][0]) < 0.05


# --- against the JAX package on its 8-device mesh ---------------------------

@pytest.fixture(scope="module")
def jax_setup():
    return (jcornell.minimal_scene(), jcornell.sky(),
            jcornell.minimal_camera())


@pytest.mark.parametrize("tiles,samples,layout", [(8, 1, "strided"),
                                                  (4, 2, "contiguous")])
def test_sharded_image_matches_jax(setup, jax_setup, tiles, samples, layout):
    assert len(jax.devices()) == 8
    ref = jrender.render_image_sharded(
        *jax_setup, JCFG, jmesh.make_mesh(tiles=tiles, samples=samples),
        spp=4, tonemapped=False, layout=layout)
    scene, env, cam, cfg = setup
    got = prender.render_image_sharded(
        scene, env, cam, cfg, meshlib.make_mesh(tiles, samples), spp=4,
        tonemapped=False, layout=layout)
    assert_image_bar(nn(got), np.asarray(ref))


def test_low_discrepancy_sharded_still_is_render_image(setup, jax_setup):
    """Under ``cfg.low_discrepancy`` the port's tiles-only sharded still
    keeps ``render_image``'s bits: both draw their camera rays through
    ``rng.sampler4``. The JAX sharded still draws ``uniform4`` whatever
    the flag (``raytracingpbr_tpu/parallel/render.py:104``), so there the
    flag leaves the image as it was, unlike JAX's ``render_image``."""
    scene, env, cam, cfg = setup
    ld = cfg.replace(low_discrepancy=True)
    single = integ.render_image(scene, env, cam, ld, spp=4, tonemapped=False)
    sharded = prender.render_image_sharded(
        scene, env, cam, ld, meshlib.make_mesh(8, 1), spp=4,
        tonemapped=False, layout="strided")
    assert torch.equal(sharded, single)
    assert not torch.equal(single, integ.render_image(
        scene, env, cam, cfg, spp=4, tonemapped=False))
    m = jmesh.make_mesh(tiles=8, samples=1)
    j_ld, j_plain = (np.asarray(jrender.render_image_sharded(
        *jax_setup, c, m, spp=4, tonemapped=False))
        for c in (JCFG.replace(low_discrepancy=True), JCFG))
    np.testing.assert_array_equal(j_ld, j_plain)


def _lanes_close(a, b, rtol=1e-4, atol=1e-6):
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1)


@pytest.mark.parametrize("tiles,samples,layout", [(8, 1, "strided"),
                                                  (4, 2, "contiguous")])
def test_sharded_frame_matches_jax(setup, jax_setup, tiles, samples,
                                   layout):
    """Two JAX frames on its mesh, the sharded state converted to the
    port's rows (``convert.frame_state_from_jax(mesh=...)``), then one
    more frame each: pixels and state at rtol 1e-4 on 99% of lanes."""
    cfg_j = JCFG.replace(samples_per_frame=2)
    jm = jmesh.make_mesh(tiles=tiles, samples=samples)
    jframe = jax.jit(lambda st: jrender.render_frame_sharded(
        *jax_setup[:2], jax_setup[2], st, cfg_j, jm, layout=layout))
    _, mid = frames(jframe, jrender.shard_frame_state(
        j_make_state(cfg_j.num_pixels), jm), 2)
    j_px, j_next = jframe(mid)

    scene, env, cam, _ = setup
    mesh = meshlib.make_mesh(tiles, samples)
    state = convert.frame_state_from_jax(mid, CPU, mesh=mesh)
    t_px, t_next = prender.render_frame_sharded(
        scene, env, cam, state, convert.config_from_jax(cfg_j), mesh,
        layout=layout)
    got = convert.frame_state_to_numpy(t_next)
    np.testing.assert_array_equal(got["respawn"], np.asarray(j_next.respawn))
    for k, v in {"accum": j_next.accum, "rays.origin": j_next.rays.origin,
                 "rays.depth": j_next.rays.depth,
                 "hit_t": j_next.hit_t}.items():
        frac = _lanes_close(got[k], np.asarray(v)).mean()
        assert frac >= 0.99, f"{k}: only {frac:.2%} of lanes agree"
    assert _lanes_close(nn(t_px), np.asarray(j_px)).mean() >= 0.99
    img_j = jrender.gather_image(j_px, cfg_j, tiles, layout)
    img_t = prender.gather_image(t_px, CFG, mesh, layout)
    assert _lanes_close(nn(img_t).reshape(-1, 3),
                        np.asarray(img_j).reshape(-1, 3)).mean() >= 0.99


def test_image_order_state_shards_as_jax_permutes(jax_setup):
    """A JAX state in image order (``render_frame``'s) goes to the port's
    rows through ``shard_frame_state``, as JAX's ``shard_pixels`` orders
    them."""
    cfg_j = JCFG.replace(samples_per_frame=2)
    from raytracingpbr_tpu.ops import integrator as jinteg
    _, st = jinteg.render_frame(*jax_setup, j_make_state(cfg_j.num_pixels),
                                cfg_j)
    mesh = meshlib.make_mesh(8, 1)
    got = prender.shard_frame_state(convert.frame_state_from_jax(st, CPU),
                                    mesh, "strided")
    for k in ("accum", "hit_t", "respawn"):
        want = np.asarray(jrender.shard_pixels(getattr(st, k), 8, "strided"))
        np.testing.assert_array_equal(nn(getattr(got, k)),
                                      want.astype(nn(getattr(got, k)).dtype))


def test_three_train_steps_match_jax_mesh():
    """Three steps of the port's (4, 2) mesh against JAX's on its 8
    devices (dual buffer, albedo only, Adam under the cosine schedule):
    loss and albedo at rtol 1e-4; the trained scene carried back to JAX
    (``convert.scene_to_numpy``) renders as the port's does."""
    env, cam = rt.white_sky(), rt.make_camera(
        lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=40.0, aspect=1.0,
        aperture=0.0, focus=1.0)

    def jsphere(albedo):
        return rt.make_scene([JSpec(JSHAPE.SPHERE, position=(0, 0, 0),
                                    scale=(1, 1, 1), albedo=albedo,
                                    roughness=1.0)])
    target = jtrain.render_pixels(
        jsphere((0.2, 0.6, 0.8)), env, cam,
        jnp.arange(TRAIN_JCFG.num_pixels, dtype=jnp.uint32), TRAIN_JCFG,
        spp=2, sample_offset=jnp.uint32(10_000), differentiable=False)
    opt = optax.adam(optax.cosine_decay_schedule(0.08, 30, alpha=0.05))
    jstep = jtrain.make_sharded_train_step(
        env, cam, TRAIN_JCFG, jmesh.make_mesh(tiles=4, samples=2), opt,
        spp=2, param_filter=jtrain.albedo_only_filter)
    jts = jtrain.make_train_state(jsphere((0.5, 0.5, 0.5)), opt)

    tstep = ptrain.make_sharded_train_step(
        tr.white_sky(device=CPU), sphere_camera(), TRAIN_CFG,
        meshlib.make_mesh(4, 2), spp=2,
        param_filter=ptrain.albedo_only_filter)
    tts = ptrain.make_train_state(
        convert.scene_from_jax(jts.scene, CPU),
        ptrain.adam(ptrain.cosine_decay_schedule(0.08, 30, alpha=0.05)))
    t_target = tt(np.asarray(target))
    for _ in range(3):
        jts, jloss = jstep(jts, target)
        tts, tloss = tstep(tts, t_target)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(nn(tts.scene.albedo),
                                   np.asarray(jts.scene.albedo), rtol=1e-4)
    back = jts.scene.replace(**{k: jnp.asarray(v) for k, v in
                                convert.scene_to_numpy(tts.scene).items()})
    np.testing.assert_array_equal(np.asarray(back.albedo),
                                  nn(tts.scene.albedo))
    pid = jnp.arange(TRAIN_JCFG.num_pixels, dtype=jnp.uint32)
    j_img = jtrain.render_pixels(back, env, cam, pid, TRAIN_JCFG, spp=1,
                                 differentiable=False)
    t_img = ptrain.render_pixels(tts.scene, tr.white_sky(device=CPU),
                                 sphere_camera(), torch.arange(256),
                                 TRAIN_CFG, spp=1, differentiable=False)
    assert _lanes_close(nn(t_img), np.asarray(j_img)).mean() >= 0.99
