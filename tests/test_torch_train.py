"""The port's train step (``parallel/train.py``) on the CPU: three steps
equal to the JAX package's ``make_sharded_train_step`` on a one-device
mesh, ``tests/test_parallel.py``'s albedo recovery in one process, a
1 x 1 mesh equal to the one-process step bit for bit, ``param_mask``,
and the signed-permutation records dropped when the matrix trains (the
march kernels' pack, mirrored on the CPU, must march the updated scene
as the plain geometry does)."""
import jax
import numpy as np
import optax
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.ops.scene import ObjectSpec as JSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu.parallel import mesh as jmesh
from raytracingpbr_tpu.parallel import train as jtrain
import raytracingpbr_tpu_torch as tr
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops.scene import ObjectSpec
from raytracingpbr_tpu_torch.ops.sdf import SHAPE
from raytracingpbr_tpu_torch.parallel import mesh as meshlib
from raytracingpbr_tpu_torch.parallel import train as ptrain

from .test_torch_march_groups import _group_fold
from .torch_helpers import CPU, nn, tt

JCFG = rt.RenderConfig(
    resolution=(16, 16), max_raymarch=48, max_raytrace=4, light_quality=1e9,
    roulette=rt.Roulette.EXP, omega=1.0,
    omega_policy=rt.OmegaPolicy.CONSTANT,
    hit_criterion=rt.HitCriterion.ABSOLUTE, hit_precision=1e-4,
    march_t0=0.005, max_dis=100.0)
CFG = convert.config_from_jax(JCFG)
TRUE_ALBEDO = (0.2, 0.6, 0.8)


def jax_scene(albedo):
    return rt.make_scene([JSpec(JSHAPE.SPHERE, position=(0, 0, 0),
                                scale=(1, 1, 1), albedo=albedo,
                                roughness=1.0)])


def port_scene(albedo):
    return tr.make_scene([ObjectSpec(SHAPE.SPHERE, position=(0, 0, 0),
                                     scale=(1, 1, 1), albedo=albedo,
                                     roughness=1.0)], device=CPU)


def port_camera():
    return tr.make_camera(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=40.0,
                          aspect=1.0, aperture=0.0, focus=1.0, device=CPU)


def port_target(spp=8):
    """The true scene rendered with many samples from far sample ids."""
    return ptrain.render_pixels(
        port_scene(TRUE_ALBEDO), tr.white_sky(device=CPU), port_camera(),
        torch.arange(CFG.num_pixels), CFG, spp=spp, sample_offset=10_000,
        differentiable=False)


def test_three_steps_match_jax_one_device_mesh():
    """Loss and albedo after each of three steps equal JAX's step on a
    one-device mesh (dual buffer, albedo only, Adam under the cosine
    schedule) at rtol 1e-4."""
    env, cam = rt.white_sky(), rt.make_camera(
        lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=40.0, aspect=1.0,
        aperture=0.0, focus=1.0)
    target = jtrain.render_pixels(
        jax_scene(TRUE_ALBEDO), env, cam,
        jax.numpy.arange(JCFG.num_pixels, dtype=jax.numpy.uint32), JCFG,
        spp=2, sample_offset=jax.numpy.uint32(10_000), differentiable=False)
    opt = optax.adam(optax.cosine_decay_schedule(0.08, 30, alpha=0.05))
    mesh = jmesh.make_mesh(devices=jax.devices()[:1])
    jstep = jtrain.make_sharded_train_step(
        env, cam, JCFG, mesh, opt, spp=2,
        param_filter=jtrain.albedo_only_filter)
    jts = jtrain.make_train_state(jax_scene((0.5, 0.5, 0.5)), opt)

    tstep = ptrain.make_sharded_train_step(
        tr.white_sky(device=CPU), port_camera(), CFG, spp=2,
        param_filter=ptrain.albedo_only_filter)
    tts = ptrain.make_train_state(
        port_scene((0.5, 0.5, 0.5)),
        ptrain.adam(ptrain.cosine_decay_schedule(0.08, 30, alpha=0.05)))
    t_target = tt(np.asarray(target))
    for _ in range(3):
        jts, jloss = jstep(jts, target)
        tts, tloss = tstep(tts, t_target)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(nn(tts.scene.albedo),
                                   np.asarray(jts.scene.albedo), rtol=1e-4)
    assert tts.step == 3
    # the frozen fields stayed where they were, bit for bit
    assert torch.equal(tts.scene.scale, torch.ones((1, 3)))
    assert torch.equal(tts.scene.emission, torch.ones((1, 3)))


def test_albedo_recovery_one_process():
    """``tests/test_parallel.py``'s fit on one process: 30 steps of Adam
    under the cosine schedule from 0.08, albedo only; the last three
    losses average under 0.2x the first and the albedo is within 0.1 of
    the truth. The caller's scene is left as it was."""
    start = port_scene((0.5, 0.5, 0.5))
    step = ptrain.make_sharded_train_step(
        tr.white_sky(device=CPU), port_camera(), CFG, spp=2,
        param_filter=ptrain.albedo_only_filter)
    ts = ptrain.make_train_state(
        start, ptrain.adam(ptrain.cosine_decay_schedule(0.08, 30,
                                                        alpha=0.05)))
    target = port_target()
    losses = []
    for _ in range(30):
        ts, loss = step(ts, target)
        losses.append(float(loss))
    assert np.mean(losses[-3:]) < losses[0] * 0.2
    np.testing.assert_allclose(nn(ts.scene.albedo)[0], TRUE_ALBEDO,
                               atol=0.1)
    assert torch.equal(start.albedo, torch.full((1, 3), 0.5))


def test_param_mask_zeroes_the_frozen_fields():
    """``param_mask`` keeps the named fields' gradients and zeroes every
    other field's; the filters carry their kept sets."""
    scene = tcornell.full_scene(CPU)
    g = tscene.with_params(scene, [torch.full_like(v, 2.0)
                                   for v in tscene.params(scene)])
    for filt, keep in ((ptrain.param_mask({"albedo", "scale"}),
                        {"albedo", "scale"}),
                       (ptrain.albedo_only_filter, {"albedo"}),
                       (ptrain.material_only_filter,
                        {"albedo", "emission", "roughness", "metallic",
                         "transmission", "ior"})):
        out = filt(g)
        assert filt.keep == keep
        for k in tscene._BUFFERS:
            want = 2.0 if k in keep else 0.0
            assert (getattr(out, k) == want).all(), k
        assert out.rot_perm == scene.rot_perm


def one_process_step(ts, target, spp):
    """The one-process step written out: every pixel, sample ids from
    ``step * 2 * spp``, the dual-buffer surrogate's scan-AD gradient, the
    albedo filter, Adam."""
    scene = ts.scene
    leaves = [v.detach().requires_grad_(True) for v in tscene.params(scene)]
    sc = tscene.with_params(scene, leaves)
    pid = torch.arange(CFG.num_pixels)
    base = ts.step * 2 * spp
    env, cam = tr.white_sky(device=CPU), port_camera()
    img_b = ptrain.render_pixels(sc, env, cam, pid, CFG, spp=spp,
                                 sample_offset=base)
    with torch.no_grad():
        img_a = ptrain.render_pixels(scene, env, cam, pid, CFG, spp=spp,
                                     sample_offset=base + spp,
                                     differentiable=False)
    resid = img_a - target
    loss = torch.mean(resid * (img_b.detach() - target))
    grads = torch.autograd.grad(torch.mean(2.0 * resid * img_b), leaves,
                                allow_unused=True)
    g = ptrain.albedo_only_filter(tscene.with_params(scene, [
        torch.zeros_like(v) if d is None else d
        for v, d in zip(leaves, grads)]))
    opt, schedule = ts.opt_state
    for v, d in zip(tscene.params(scene), tscene.params(g)):
        v.grad = d
    opt.step()
    opt.zero_grad(set_to_none=True)
    schedule.step()
    return ptrain.TrainState(scene, ts.opt_state, ts.step + 1), loss


def test_one_by_one_mesh_is_the_one_process_step():
    """A 1 x 1 mesh (and ``mesh=None``) takes the one-process step: one
    rank renders every pixel from sample id ``step * 2 * spp``, and the
    mean over one rank changes no bit. Three steps each, loss and every
    buffer equal bit for bit to the step written out."""
    target = port_target(spp=2)
    make = lambda: ptrain.make_train_state(
        port_scene((0.5, 0.5, 0.5)),
        ptrain.adam(ptrain.cosine_decay_schedule(0.08, 30, alpha=0.05)))
    ref = make()
    runs = {}
    for mesh in (None, meshlib.make_mesh(1, 1)):
        step = ptrain.make_sharded_train_step(
            tr.white_sky(device=CPU), port_camera(), CFG, mesh, spp=2,
            param_filter=ptrain.albedo_only_filter)
        runs[mesh] = (step, make())
    for _ in range(3):
        ref, want = one_process_step(ref, target, spp=2)
        for mesh, (step, ts) in runs.items():
            ts, loss = step(ts, target)
            runs[mesh] = (step, ts)
            assert torch.equal(loss, want), mesh
            for a, b in zip(tscene.params(ts.scene), tscene.params(ref.scene)):
                assert torch.equal(a, b), mesh
            assert ts.step == ref.step


def test_training_the_matrix_drops_rot_perm():
    """A step that trains ``matrix`` on the Cornell box (its boxes signed
    permutations) moves the matrices off the permutations; the updated
    scene has no permutation records, and the march kernels' pack of it
    (``pack_groups``' fold, mirrored on the CPU) gives the plain
    geometry's nearest index and distance bit for bit, where the stale
    records would not. With the matrix frozen the records stay."""
    scene = tcornell.full_scene(CPU)
    cfg = tcornell.full_config().replace(resolution=(8, 8), max_raytrace=3,
                                         max_raymarch=96)
    # a sky that varies with direction: under the black one the image is
    # piecewise constant in the geometry
    cam, env = tcornell.full_camera(CPU), tr.gradient_sky(device=CPU)
    target = torch.zeros((cfg.num_pixels, 3))
    assert any(p is not None for p in scene.rot_perm)

    frozen = ptrain.make_sharded_train_step(
        env, cam, cfg, param_filter=ptrain.material_only_filter)
    ts = ptrain.make_train_state(scene, ptrain.adam(0.05))
    ts, _ = frozen(ts, target)
    assert ts.scene.rot_perm == scene.rot_perm
    assert torch.equal(ts.scene.matrix, scene.matrix)

    step = ptrain.make_sharded_train_step(
        env, cam, cfg, param_filter=ptrain.param_mask({"matrix"}))
    ts = ptrain.make_train_state(scene, ptrain.adam(0.05))
    ts, _ = step(ts, target)
    moved = ts.scene
    assert not torch.equal(moved.matrix, scene.matrix)
    assert all(p is None for p in moved.rot_perm)

    p = tt(np.random.default_rng(0).uniform(-1.5, 1.5, (4000, 3)).astype(
        np.float32))
    want_idx, want_d = tscene.nearest(moved, p)
    idx, d = _group_fold(moved, p)
    np.testing.assert_array_equal(nn(idx), nn(want_idx))
    np.testing.assert_array_equal(nn(d), nn(want_d))
    stale = moved.replace(rot_perm=scene.rot_perm)
    _, d_stale = _group_fold(stale, p)
    assert not torch.equal(d_stale, want_d)
