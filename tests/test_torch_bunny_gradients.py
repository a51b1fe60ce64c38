"""Gradients through the neural-SDF bunny on the CPU, the port against the
JAX package: the implicit hit-point VJP (``ops/march._hit_t``) and the
second-order normal on bunny points, scan-AD through the glass bunny with
the MLP marched in K1c's order and in the matmul form (``bunny_mxu``),
finite differences in float64, replay against scan-AD, three train steps
that train the MLP (``param_mask(set())``, as JAX's step does on a bunny
scene), and trained weights carried across ``convert`` both ways.

The JAX side runs its own XLA path on the CPU (its march is not the
Pallas kernel there), one module-scoped fixture per JAX computation. The
scene is ``models/bunny``'s glass bunny under its HDR sky, seen by a
pinhole camera at vfov 25 that the bunny fills, at 8x8 pixels and 3
bounces: the port's plain march evaluates the MLP elementwise, so the
CPU run stays small.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu.ops import scene as jscene
from raytracingpbr_tpu.ops import sdf as jsdf
from raytracingpbr_tpu.parallel import mesh as jmesh
from raytracingpbr_tpu.parallel import train as jtrain
import raytracingpbr_tpu_torch as tr
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.models.demo import synthetic_hdr
from raytracingpbr_tpu_torch.ops import ibl as tibl
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops import sdf as tsdf
from raytracingpbr_tpu_torch.ops.sdf import BunnyMLP
from raytracingpbr_tpu_torch.parallel import train as ptrain

from .test_torch_hit_t import close
from .torch_helpers import CPU, nn, tt

F64 = torch.float64
MLP = tuple("bunny_" + k for k in BunnyMLP._fields)
JCFG = jbunny.glass_config().replace(resolution=(8, 8), max_raytrace=3,
                                     samples_per_pixel=1)
CFG = convert.config_from_jax(JCFG)


def jax_camera():
    return rt.make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          vfov=25.0, aspect=1.0, aperture=0.0, focus=3.0)


def port_camera(dtype=torch.float32):
    return tr.make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                          vfov=25.0, aspect=1.0, aperture=0.0, focus=3.0,
                          device=CPU, dtype=dtype)


def jax_ref(tree, name):
    """A field of a JAX scene (or of its gradient) by the port's name."""
    if name.startswith("bunny_"):
        return np.asarray(getattr(tree.bunny, name[len("bunny_"):]))
    return np.asarray(getattr(tree, name))


def port_leaves(js):
    """The JAX scene converted, with every float buffer (the MLP's eight
    tensors included) a leaf that requires grad."""
    ts = convert.scene_from_jax(js, CPU)
    leaves = [v.clone().requires_grad_(True) for v in tscene.params(ts)]
    return ts, leaves, tscene.with_params(ts, leaves)


def bunny_rays(n=192, seed=0):
    """Rays from around the camera's eye toward points in the bunny's unit
    sphere: most hit the bunny, some miss it."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, 3.0]) + rng.normal(0, 0.2, (n, 3))
    d = rng.uniform(-0.9, 0.9, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# --- (a) the implicit hit-point VJP on bunny lanes ---------------------------

STEEP = 0.1  # |cos| of the hit angle, (df/dt) / |grad_p f|, below: grazing


@pytest.fixture(scope="module", params=["steep", "grazing"])
def hit_t_vjp(request):
    """JAX's ``_hit_t`` VJP (a ``custom_vjp``) and the port's ``_HitT``
    backward on the same glass-bunny lanes: the hits whose ray meets the
    surface at |cos| >= STEEP with the misses ("steep"), or every lane,
    grazing hits included ("grazing")."""
    js = jbunny.glass_scene()
    o, d = bunny_rays()
    res = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), JCFG,
                       differentiable=False)
    t, idx, hit = (np.asarray(res.t), np.asarray(res.index),
                   np.asarray(res.hit))
    grad_p = np.asarray(jax.grad(lambda q: jnp.sum(jscene.sd_object(
        js, jnp.asarray(idx), q)))(res.position))
    cos = (grad_p * d).sum(-1) / np.linalg.norm(grad_p, axis=-1)
    grazing = hit & (np.abs(cos) < STEEP)
    assert grazing.any() and (hit & ~grazing).any() and (~hit).any()
    if request.param == "steep":
        o, d, t, idx, hit = (v[~grazing] for v in (o, d, t, idx, hit))
    g = np.random.default_rng(1).normal(size=t.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda sc, oo, dd: jmarch._hit_t(
        sc, oo, dd, jnp.asarray(t), jnp.asarray(idx), jnp.asarray(hit)),
        js, jnp.asarray(o), jnp.asarray(d))
    j_scene, j_o, j_d = vjp(jnp.asarray(g))
    ref = {k: jax_ref(j_scene, k) for k in MLP + tscene._SDF_BUFFERS}
    ref.update(origin=np.asarray(j_o), direction=np.asarray(j_d))

    ts, leaves, sc = port_leaves(js)
    to, td = tt(o).requires_grad_(True), tt(d).requires_grad_(True)
    got_t = tmarch._hit_t(sc, to, td, tt(t), tt(idx), tt(hit))
    grads = torch.autograd.grad(got_t, leaves + [to, td], tt(g),
                                allow_unused=True)
    got = dict(zip(tscene.param_names(ts), grads[:-2]))
    got.update(origin=grads[-2], direction=grads[-1])
    return request.param, got, ref, hit, nn(got_t), t


def test_hit_t_on_bunny_lanes_is_the_identity(hit_t_vjp):
    _, got, _, hit, t_out, t = hit_t_vjp
    np.testing.assert_array_equal(t_out, t)
    # a miss lane takes no gradient
    assert (~hit).any() and (nn(got["origin"])[~hit] == 0).all()


@pytest.mark.parametrize("field", MLP + ("position", "matrix",
                                         "local_offset", "origin",
                                         "direction"))
def test_hit_t_vjp_on_bunny_matches_jax(hit_t_vjp, field):
    """``_HitT``'s backward on bunny lanes against JAX's ``_hit_t``: every
    MLP tensor, the transforms, the origin and the direction. On the
    steep lanes at rtol 1e-5 (an absolute floor of 1e-6 of the largest
    entry). A lane's coefficient is ``-g / (df/dt)``: the two frameworks'
    ``grad_p f`` through the MLP's contractions differ by up to ~6e-7,
    which a grazing lane's small ``df/dt`` (down to ~5e-3 here) divides,
    so with the grazing lanes in the bar is rtol 1e-4 with a floor of
    1e-4 of the largest entry."""
    lanes, got, ref, *_ = hit_t_vjp
    assert np.abs(ref[field]).max() > 0, field  # a real gradient
    assert np.isfinite(nn(got[field])).all(), field
    if lanes == "steep":
        close(got[field], ref[field])
    else:
        close(got[field], ref[field], rtol=1e-4, floor=1e-4)


# --- (b) the normal, second order through the MLP ----------------------------

@pytest.fixture(scope="module", params=["surface", "off_surface"])
def normal_vjp(request):
    """``jax.vjp`` of JAX's ``calc_normal`` (a ``jax.grad`` inside) and the
    port's ``create_graph`` normal, in the scene and the point: on the
    bunny's surface, and on points moved off it (inside and outside the
    unit sphere, so both branches of ``sd_bunny``'s guard)."""
    js = jbunny.glass_scene()
    o, d = bunny_rays(seed=2)
    res = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), JCFG,
                       differentiable=False)
    keep = np.asarray(res.hit)
    p = np.asarray(res.position)[keep]
    idx = np.asarray(res.index)[keep]
    if request.param == "off_surface":
        p = p + np.random.default_rng(3).normal(0, 0.1, p.shape).astype(
            np.float32)
        assert (np.linalg.norm(p, axis=-1) > 1.0).any()
    cot = np.random.default_rng(4).normal(size=p.shape).astype(np.float32)
    n_j, vjp = jax.vjp(lambda sc, q: jscene.calc_normal(
        sc, jnp.asarray(idx), q), js, jnp.asarray(p))
    j_scene, j_p = vjp(jnp.asarray(cot))
    ref = {k: jax_ref(j_scene, k) for k in MLP + ("position", "matrix")}
    ref["p"] = np.asarray(j_p)

    ts, leaves, sc = port_leaves(js)
    tp = tt(p).requires_grad_(True)
    n_t = tscene.calc_normal(sc, tt(idx), tp)
    grads = torch.autograd.grad(n_t, leaves + [tp], tt(cot),
                                allow_unused=True)
    got = dict(zip(tscene.param_names(ts), grads[:-1]))
    got["p"] = grads[-1]
    return got, ref, nn(n_t), np.asarray(n_j)


@pytest.mark.parametrize("field", MLP + ("position", "matrix", "p"))
def test_normal_second_order_through_the_mlp_matches_jax(normal_vjp, field):
    """The normal agrees first (rtol 1e-5), then its VJP in every MLP
    tensor, the transforms and the point at rtol 1e-5 (floor 1e-6 of the
    largest entry); none reaches the output bias."""
    got, ref, n_t, n_j = normal_vjp
    np.testing.assert_allclose(n_t, n_j, rtol=1e-5, atol=1e-6)
    if field == "bunny_bias_out":
        # a uniform offset of the SDF leaves its gradient, so the normal,
        # as it is
        assert not np.asarray(ref[field]).any()
        assert got[field] is None or not got[field].any()
        return
    assert np.abs(ref[field]).max() > 0, field
    close(got[field], ref[field])


# --- (c) scan-AD through the glass bunny ------------------------------------

PIX_W = np.random.default_rng(5).uniform(0.5, 1.5, (CFG.num_pixels, 3)) \
    .astype(np.float32)


@pytest.fixture(scope="module")
def jax_render_grads():
    """``jax.grad`` of a weighted pixel sum through JAX's ``render_pixels``
    (scan-AD) in the whole glass-bunny scene, its MLP included; and the
    image."""
    scene, env = jbunny.glass_scene(), jbunny.glass_environment()
    pid = jnp.arange(JCFG.num_pixels, dtype=jnp.uint32)

    def loss(sc):
        img = jtrain.render_pixels(sc, env, jax_camera(), pid, JCFG, spp=1)
        return jnp.sum(img * PIX_W) / JCFG.num_pixels, img
    (_, img), g = jax.value_and_grad(loss, has_aux=True)(scene)
    return g, np.asarray(img)


def port_render_grads(mxu):
    ts, leaves, sc = port_leaves(jbunny.glass_scene())
    img = ptrain.render_pixels(
        sc, tbunny.glass_environment(device=CPU),
        port_camera(), torch.arange(CFG.num_pixels),
        CFG.replace(bunny_mxu=mxu), spp=1)
    loss = torch.sum(img * tt(PIX_W)) / CFG.num_pixels
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return dict(zip(tscene.param_names(ts), grads)), nn(img)


@pytest.fixture(scope="module", params=[False, True], ids=["k1c", "k1d"])
def port_grads(request):
    """The port's scan-AD gradients of the same sum, the march's MLP in
    K1c's order (``bunny_mxu`` off) or in the matmul form (on)."""
    return port_render_grads(request.param)


@pytest.mark.parametrize("field", MLP + ("position", "matrix", "albedo"))
def test_render_pixels_bunny_grad_matches_jax(jax_render_grads, port_grads,
                                              field):
    """The image within rtol 1e-4, then each gradient at rtol 1e-4 with a
    floor of 1e-5 of its largest entry, as
    ``test_torch_gradients.test_render_pixels_grad_matches_jax``."""
    jg, j_img = jax_render_grads
    got, t_img = port_grads
    np.testing.assert_allclose(t_img, j_img, rtol=1e-4, atol=1e-6)
    want = jax_ref(jg, field).astype(np.float64)
    assert np.abs(want).max() > 0, field
    g = nn(got[field]).astype(np.float64)
    assert np.isfinite(g).all(), field
    np.testing.assert_allclose(g, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


# --- (d) finite differences in float64 --------------------------------------

def f64_setup():
    """The glass bunny, its sky and the pinhole camera in float64. The hit
    test is an absolute 1e-9: the implicit gradient is that of a point on
    the surface, while at 8x8 the relative test stops a march up to a
    pixel radius (1/8 of the distance) short of it, where the image moves
    with the whole sequence of steps."""
    sc = tbunny.glass_scene(CPU)
    sc = tscene.with_params(sc, [v.double() for v in tscene.params(sc)])
    env = tibl.hdr_environment(synthetic_hdr(seed=1), exposure=1.0,
                               gamma=2.2, bilinear=True, device=CPU,
                               dtype=F64)
    cam = port_camera(F64)
    cfg = CFG.replace(hit_criterion=tr.HitCriterion.ABSOLUTE,
                      hit_precision=1e-9, light_quality=1e9)
    return sc, env, cam, cfg


@pytest.mark.parametrize("field,index", [("bunny_bias_out", ()),
                                         ("matrix", (0, 1, 2))])
def test_bunny_grad_against_finite_differences_f64(field, index):
    """Autograd against central differences (eps 1e-5) of the weighted
    pixel sum in float64, at rel 1e-3 (``tests/test_gradients.py``'s
    oracle): the MLP's output bias, a uniform offset of the SDF, and one
    entry of the bunny's rotation."""
    sc, env, cam, cfg = f64_setup()
    pid = torch.arange(cfg.num_pixels)
    w = torch.as_tensor(PIX_W, dtype=F64)
    names = tscene.param_names(sc)
    base = tscene.params(sc)
    k = names.index(field)

    def f(x):
        v = base[k].clone()
        v[index] = x
        vals = list(base)
        vals[k] = v
        img = ptrain.render_pixels(tscene.with_params(sc, vals), env, cam,
                                   pid, cfg, spp=1)
        return torch.sum(img * w) / cfg.num_pixels

    x0 = float(base[k][index])
    x = torch.tensor(x0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(f(x), x)
    eps = 1e-5
    with torch.no_grad():
        fd = (float(f(torch.tensor(x0 + eps, dtype=F64)))
              - float(f(torch.tensor(x0 - eps, dtype=F64)))) / (2 * eps)
    assert abs(fd) > 1e-3, fd  # a real gradient
    assert float(g) == pytest.approx(fd, rel=1e-3), (float(g), fd)


# --- (e) replay against scan-AD ---------------------------------------------

def test_replay_equals_scan_ad_on_the_bunny():
    """Path replay (materials and the environment, as the JAX package
    scopes it) against scan-AD on the glass bunny at 6 bounces: the
    albedo and the sky's scale at rtol 2e-4 (``tests/test_replay.py``'s
    bar), with the MLP marched both ways."""
    scene = tbunny.glass_scene(CPU)
    env = tbunny.glass_environment(device=CPU)
    cam = port_camera()
    pid = torch.arange(CFG.num_pixels)
    for mxu in (False, True):
        cfg = CFG.replace(max_raytrace=6, bunny_mxu=mxu)
        grads = {}
        for mode in (True, "replay"):
            albedo = scene.albedo.clone().requires_grad_(True)
            scale = env.scale.clone().requires_grad_(True)
            img = ptrain.render_pixels(scene.replace(albedo=albedo),
                                       env.replace(scale=scale), cam, pid,
                                       cfg, spp=1, differentiable=mode)
            grads[mode] = torch.autograd.grad(
                torch.sum(img * tt(PIX_W)), (albedo, scale))
        for a, b in zip(grads[True], grads["replay"]):
            assert float(a.abs().max()) > 0
            torch.testing.assert_close(b, a, rtol=2e-4,
                                       atol=2e-6 * float(a.abs().max()))


# --- (f) training the MLP ---------------------------------------------------

STEPS = 3
LR = 1e-3
BIAS_SHIFT = 0.01


@pytest.fixture(scope="module")
def train_runs():
    """Three train steps of JAX's ``make_sharded_train_step`` on a
    one-device mesh and of the port's, both with ``param_mask(set())``
    (every object buffer frozen, the MLP trained), Adam at a constant
    rate, dual buffer: from the glass bunny with its output bias shifted
    by BIAS_SHIFT toward a render of the true weights."""
    env, cam = jbunny.glass_environment(), jax_camera()
    true = jbunny.glass_scene()
    start = true.replace(bunny=true.bunny.replace(
        bias_out=true.bunny.bias_out + BIAS_SHIFT))
    pid = jnp.arange(JCFG.num_pixels, dtype=jnp.uint32)
    target = jtrain.render_pixels(true, env, cam, pid, JCFG, spp=2,
                                  sample_offset=jnp.uint32(10_000),
                                  differentiable=False)
    opt = optax.adam(LR)
    jstep = jtrain.make_sharded_train_step(
        env, cam, JCFG, jmesh.make_mesh(devices=jax.devices()[:1]), opt,
        spp=1, param_filter=jtrain.param_mask(set()))
    jts = jtrain.make_train_state(start, opt)

    tstep = ptrain.make_sharded_train_step(
        tbunny.glass_environment(device=CPU), port_camera(), CFG, spp=1,
        param_filter=ptrain.param_mask(set()))
    tts = ptrain.make_train_state(convert.scene_from_jax(start, CPU),
                                  ptrain.adam(LR))
    t_target = tt(np.asarray(target))
    runs = []
    for _ in range(STEPS):
        jts, jloss = jstep(jts, target)
        tts, tloss = tstep(tts, t_target)
        runs.append((float(jloss), float(tloss),
                     {k: jax_ref(jts.scene, k) for k in MLP},
                     {k: nn(getattr(tts.scene.bunny,
                                    k[len("bunny_"):])).copy()
                      for k in MLP}))  # Adam steps the tensors in place
    return runs, jts, tts, convert.scene_from_jax(start, CPU)


def test_train_steps_losses_match_jax(train_runs):
    """The three losses at rtol 1e-4."""
    runs, *_ = train_runs
    for jloss, tloss, _, _ in runs:
        assert np.isfinite(tloss)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


@pytest.mark.parametrize("field", MLP)
def test_train_steps_mlp_weights_match_jax(train_runs, field):
    """After each step every MLP tensor equals JAX's at rtol 1e-4, and the
    step moved it (the MLP trains under ``param_mask(set())``)."""
    runs, _, _, start = train_runs
    before = nn(getattr(start.bunny, field[len("bunny_"):]))
    for _, _, jw, tw in runs:
        np.testing.assert_allclose(tw[field], jw[field], rtol=1e-4)
    assert not np.array_equal(runs[-1][3][field], before), field


def test_train_steps_freeze_the_object_buffers(train_runs):
    """``param_mask(set())`` leaves every object buffer as it was, bit for
    bit, and the signed-permutation records stand (the matrix did not
    train)."""
    _, _, tts, start = train_runs
    for k in tscene._BUFFERS:
        assert torch.equal(getattr(tts.scene, k), getattr(start, k)), k
    assert tts.scene.rot_perm == start.rot_perm


# --- (g) trained weights across convert -------------------------------------

def test_convert_round_trips_trained_mlp_weights(train_runs):
    """The port's trained scene carried to JAX (``scene_to_numpy`` with
    JAX's ``BunnyMLP``) and back (``scene_from_jax``): every buffer and
    MLP tensor bit for bit, and JAX's bunny SDF of the carried weights
    equal to the port's."""
    _, jts, tts, _ = train_runs
    back = jts.scene.replace(**convert.scene_to_numpy(
        tts.scene, bunny_type=jsdf.BunnyMLP))
    for k in MLP + tscene._BUFFERS:
        np.testing.assert_array_equal(jax_ref(back, k),
                                      nn(getattr(tts.scene, k)
                                         if k in tscene._BUFFERS else
                                         getattr(tts.scene.bunny,
                                                 k[len("bunny_"):])))
    again = convert.scene_from_jax(back, CPU)
    for a, b in zip(tscene.params(again), tscene.params(tts.scene)):
        assert torch.equal(a, b.detach())
    p = np.random.default_rng(6).uniform(-0.9, 0.9, (256, 3)).astype(
        np.float32)
    want = np.asarray(jsdf.sd_bunny(jnp.asarray(p), back.bunny))
    got = nn(tsdf.sd_bunny(tt(p), tts.scene.bunny))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # without a type the MLP comes as a dict of arrays
    plain = convert.scene_to_numpy(tts.scene)
    assert set(plain["bunny"]) == set(BunnyMLP._fields)
