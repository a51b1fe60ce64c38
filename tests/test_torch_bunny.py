"""Port bunny SDF, scene queries and animation against the JAX package.

Inputs are numpy points from fixed seeds; both packages get the same scene
(JAX's, converted, or the port's own where the test says so). Tolerances:

* the matmul-form MLP (``bunny_mlp_eval``, ``sd_bunny``, ``all_distances``):
  rtol 1e-5, atol 1e-6 — the same formula, summed in another order by
  XLA-CPU's dot than by PyTorch's matmul;
* the kernel-order MLP (``bunny_mlp_eval_unrolled``, ``nearest``): atol
  1e-5 — left-to-right chains of 16 products against XLA's dot, and a
  multiply by ``1/1.4`` where JAX divides;
* normals: atol 1e-4 (gradients through 48 sins);
* animation: atol 1e-6 (one 3x3 product and a sin per frame).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.ops import scene as jscene
from raytracingpbr_tpu.ops import sdf as jsdf
from raytracingpbr_tpu_torch.convert import scene_from_jax
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops import sdf as tsdf

from .torch_helpers import CPU, nn, tt


def _points(n=4096, seed=0, r_max=1.6):
    """Points in and around the unit sphere, a quarter of them in a thin
    shell about r = 1 (kept 1e-3 away from it, where the SDF switches
    form)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = rng.uniform(0.0, r_max, n)
    shell = rng.random(n) < 0.25
    r[shell] = 1.0 + rng.choice([-1, 1], shell.sum()) * rng.uniform(
        1e-3, 0.05, shell.sum())
    return (u * r[:, None]).astype(np.float32)


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_load_bunny_matches_jax():
    jb, tb = jsdf.load_bunny(), tsdf.load_bunny(CPU)
    assert tb._fields == tuple(
        f for f in ("w_in", "b_in", "w_h1", "b_h1", "w_h2", "b_h2", "w_out",
                    "bias_out"))
    for k in tb._fields:
        ref = np.asarray(getattr(jb, k))
        got = nn(getattr(tb, k))
        assert got.dtype == ref.dtype == np.float32, k
        np.testing.assert_array_equal(got, ref, k)


def test_mlp_eval_and_sd_bunny_match_jax():
    p = _points()
    jb, tb = jsdf.load_bunny(), tsdf.load_bunny(CPU)
    _close(tsdf.bunny_mlp_eval(tb, tt(p)), jsdf.bunny_mlp_eval(jb, p))
    _close(tsdf.sd_bunny(tt(p), tb), jsdf.sd_bunny(jnp.asarray(p), jb))


def test_unrolled_eval_matches_jax():
    """The march's form of the MLP, in the kernel's operation order."""
    p = _points(seed=1)
    jb, tb = jsdf.load_bunny(), tsdf.load_bunny(CPU)
    got = tsdf.bunny_mlp_eval_unrolled(tb, *(tt(p[:, k]) for k in range(3)))
    _close(got, jsdf.bunny_mlp_eval(jb, p), rtol=0, atol=1e-5)
    got = tsdf.sd_bunny_unrolled(*(tt(p[:, k]) for k in range(3)), tb)
    _close(got, jsdf.sd_bunny(jnp.asarray(p), jb), rtol=0, atol=1e-5)
    # against the port's matmul form: the same MLP to rounding
    _close(got, tsdf.sd_bunny(tt(p), tb), rtol=0, atol=1e-5)


def _scenes():
    glass = jbunny.glass_scene()
    return {"glass": glass,
            "animated": jbunny.animated_scene(glass, 12.0)}


@pytest.mark.parametrize("name", ["glass", "animated"])
def test_geometry_queries_on_bunny_scenes(name):
    js = _scenes()[name]
    ts = scene_from_jax(js, CPU)
    p = _points(seed=2)
    _close(tscene.all_distances(ts, tt(p)), jscene.all_distances(js, p))
    j_idx, j_d = jscene.nearest(js, jnp.asarray(p))
    t_idx, t_d = tscene.nearest(ts, tt(p))
    _close(t_d, j_d, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(nn(t_idx), np.asarray(j_idx))
    idx = np.zeros(p.shape[0], np.int32)
    _close(tscene.sd_object(ts, tt(idx), tt(p)),
           jscene.sd_object(js, jnp.asarray(idx), jnp.asarray(p)))
    ref = jscene.calc_normal(js, jnp.asarray(idx), jnp.asarray(p))
    got = tscene.calc_normal(ts, tt(idx), tt(p))
    _close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("frame", [0, 12, 60])
def test_animate_matches_jax(frame):
    base = jbunny.glass_scene()
    ref = jscene.animate(base, jnp.asarray(frame))
    got = tbunny.animated_scene(scene_from_jax(base, CPU), frame)
    _close(got.matrix, ref.matrix, rtol=0, atol=1e-6)
    _close(got.local_offset, ref.local_offset, rtol=0, atol=1e-6)
    assert got.rot_perm == (None,)
    # the animated scene keeps its weights and materials
    np.testing.assert_array_equal(nn(got.bunny.w_h2),
                                  np.asarray(base.bunny.w_h2))
    np.testing.assert_array_equal(nn(got.albedo), np.asarray(base.albedo))
    # a frame given as a tensor on the scene's device gives the same scene
    again = tbunny.animated_scene(scene_from_jax(base, CPU), tt(frame))
    np.testing.assert_array_equal(nn(again.matrix), nn(got.matrix))


def test_bake_matches_jax():
    js = jbunny.metal_scene()
    js = js.replace(rotation=js.rotation + jnp.asarray([[10.0, 20.0, 30.0]]))
    ref = jscene.bake(js)
    got = tscene.bake(scene_from_jax(js, CPU))
    _close(got.matrix, ref.matrix, rtol=0, atol=1e-6)
    assert got.rot_perm == ref.rot_perm == (None,)


@pytest.mark.parametrize("name", ["glass", "animated"])
def test_bounding_radius(name):
    js = _scenes()[name]
    ref = jscene.bounding_radius(js)
    got = tscene.bounding_radius(scene_from_jax(js, CPU))
    _close(got, ref, rtol=1e-6, atol=0)
    # unit-sphere support (r = 1) at the origin, plus the bob offset
    off = float(np.linalg.norm(np.asarray(js.local_offset)[0]))
    np.testing.assert_allclose(float(got), (1.0 + off) * 1.05 + 0.1,
                               rtol=1e-6)


def test_scene_from_jax_carries_the_bunny():
    js = jbunny.glass_scene()
    ts = scene_from_jax(js, CPU)
    own = tbunny.glass_scene(CPU)
    assert ts.shape_types == own.shape_types == (int(tsdf.SHAPE.BUNNY),)
    assert ts.rot_perm == own.rot_perm == tuple(js.rot_perm)
    for k in tsdf.BunnyMLP._fields:
        np.testing.assert_array_equal(nn(getattr(ts.bunny, k)),
                                      nn(getattr(own.bunny, k)))
    for k in tscene._BUFFERS:
        np.testing.assert_array_equal(nn(getattr(ts, k)),
                                      nn(getattr(own, k)), k)
    # the module's buffers carry the weights (``scene.to(device)`` moves
    # them)
    assert "bunny_w_in" in dict(ts.named_buffers())
