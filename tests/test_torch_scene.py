"""Port scene and SDF parity against JAX on random points.

Both packages get the same scene (converted from the JAX one, so the data
is identical) and the same numpy points. Tolerance: rtol 1e-5 — the
formulas are the same, but XLA-CPU contracts multiply-adds into FMAs where
PyTorch rounds every operation, so the last ulps differ. The nearest index
is compared where JAX's distance is below MAX_DIS: there JAX's argmin and
the port's strict running minimum pick the same object; beyond it the
port keeps index 0 as the march kernel does.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import scene as jscene
from raytracingpbr_tpu.ops import sdf as jsdf
from raytracingpbr_tpu.ops.scene import ObjectSpec as JSpec
from raytracingpbr_tpu_torch.convert import scene_from_jax
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops import sdf as tsdf

from .torch_helpers import nn, tt

RTOL = 1e-5


def _mixed_jax_scene():
    """Every analytic shape, arbitrary rotations, a rounded box radius and
    an animation offset."""
    S = jsdf.SHAPE
    objs = [
        JSpec(S.PLANE, (0, -1.2, 0), (0, 0, 0), (1, 0.0, 1)),
        JSpec(S.SPHERE, (0.4, 0.1, -0.3), (0, 0, 0), (0.35,) * 3),
        JSpec(S.BOX, (-0.5, -0.2, 0.1), (10, 35, -20), (0.3, 0.2, 0.25),
              albedo=(0.2, 0.5, 0.7), roughness=0.3, metallic=0.5),
        JSpec(S.BOX, (0.2, 0.6, 0.2), (90, 0, 90), (0.2, 0.1, 0.3)),
        JSpec(S.CYLINDER, (0.9, -0.4, 0.5), (0, 0, 30), (0.2, 0.4, 0.2),
              transmission=0.7, ior=1.5),
        JSpec(S.CONE, (-0.2, 0.4, -0.6), (15, 0, 0), (0.8, 0.6, 0.6)),
        JSpec(S.NONE),
    ]
    sc = jscene.make_scene(objs, box_round=0.03)
    off = np.random.default_rng(5).normal(0, 0.05, (sc.num_objects, 3))
    return sc.replace(local_offset=jnp.asarray(off, jnp.float32))


SCENES = {
    "cornell_full": jcornell.full_scene,
    "cornell_minimal": jcornell.minimal_scene,
    "engine": jdemo.engine_scene,
    "mixed": _mixed_jax_scene,
}


def _points(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("maker", ["full_scene", "minimal_scene",
                                   "v2_scene"])
def test_make_scene_matches(maker):
    j = getattr(jcornell, maker)()
    t = getattr(tcornell, maker)()
    assert t.shape_types == j.shape_types
    assert t.type_splits == j.type_splits
    assert t.bucket_types == j.bucket_types
    assert t.rot_perm == j.rot_perm
    assert t.box_round == j.box_round
    jm, tm = np.asarray(j.matrix), nn(t.matrix)
    snapped = np.isin(jm, (-1.0, 0.0, 1.0))
    np.testing.assert_array_equal(tm[snapped], jm[snapped])
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-6)
    for k in ("position", "scale", "albedo", "emission", "roughness",
              "metallic", "transmission", "ior", "local_offset"):
        np.testing.assert_array_equal(nn(getattr(t, k)),
                                      np.asarray(getattr(j, k)))


def _atol(js):
    """Two ulps of the scene's largest coordinate: a distance such as
    ``|p - c| - r`` with the engine floor's r = 100 cancels down from that
    magnitude, so its rounding error is absolute, not relative."""
    mag = float(np.max(np.abs(np.asarray(js.position)))
                + np.max(np.abs(np.asarray(js.scale))))
    return max(1e-6, 2 * float(np.spacing(np.float32(mag))))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_geometry_queries_match(name):
    js = SCENES[name]()
    ts = scene_from_jax(js)
    p = _points()
    jp, tp = jnp.asarray(p), tt(p)
    atol = _atol(js)

    np.testing.assert_allclose(nn(tscene.all_distances(ts, tp)),
                               np.asarray(jscene.all_distances(js, jp)),
                               rtol=RTOL, atol=atol)
    j_idx, j_d = (np.asarray(v) for v in jscene.nearest(js, jp))
    t_idx, t_d = (nn(v) for v in tscene.nearest(ts, tp))
    assert t_idx.dtype == np.int32
    np.testing.assert_allclose(t_d, j_d, rtol=RTOL, atol=atol)
    near = j_d < jscene.MAX_DIS
    np.testing.assert_array_equal(t_idx[near], j_idx[near])

    sel = np.random.default_rng(1).integers(0, js.num_objects, p.shape[0])
    sel = sel.astype(np.int32)
    np.testing.assert_allclose(
        nn(tscene.sd_object(ts, tt(sel), tp)),
        np.asarray(jscene.sd_object(js, jnp.asarray(sel), jp)),
        rtol=RTOL, atol=atol)

    # normals of the nearest object, where it is a real surface nearby
    use = near & (j_d < 0.5)
    idx = j_idx[use]
    jn = np.asarray(jscene.calc_normal(js, jnp.asarray(idx),
                                       jnp.asarray(p[use])))
    tn = nn(tscene.calc_normal(ts, tt(idx), tt(p[use])))
    np.testing.assert_allclose(tn, jn, rtol=RTOL, atol=1e-5)

    jm = jscene.materials_at(js, jnp.asarray(sel))
    tm = tscene.materials_at(ts, tt(sel))
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(nn(a), np.asarray(b))

    jb = jscene.bounding_radius(js)
    tb = tscene.bounding_radius(ts)
    assert (jb is None) == (tb is None)
    if jb is not None:
        np.testing.assert_allclose(float(tb), float(jb), rtol=1e-6)


def test_box_normals_split_ties_like_jax():
    """On box edges and corners the inside-max ties: JAX splits the
    gradient evenly, and so must the port (amax / maximum, not max(dim))."""
    js = jcornell.full_scene()
    ts = scene_from_jax(js)
    # points exactly on edges/corners of the back wall box (index 0 after
    # the type sort: every object is a box, order kept)
    p = np.array([[1.0, 1.0, -0.8], [1.0, 1.0, -1.2], [-1.0, 0.0, -0.8],
                  [0.5, 1.0, -0.8], [0.0, 0.0, -0.8]], np.float32)
    idx = np.zeros(len(p), np.int32)
    jn = np.asarray(jscene.calc_normal(js, jnp.asarray(idx), jnp.asarray(p)))
    tn = nn(tscene.calc_normal(ts, tt(idx), tt(p)))
    np.testing.assert_allclose(tn, jn, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("shape", ["sd_sphere", "sd_round_box", "sd_box",
                                   "sd_cylinder", "sd_cone", "sd_plane",
                                   "sd_none"])
def test_sdf_primitives_match(shape):
    rng = np.random.default_rng(3)
    p = rng.normal(0, 0.6, (2048, 3)).astype(np.float32)
    s = rng.uniform(0.1, 0.8, (2048, 3)).astype(np.float32)
    ref = getattr(jsdf, shape)(jnp.asarray(p), jnp.asarray(s))
    got = getattr(tsdf, shape)(tt(p), tt(s))
    np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=RTOL,
                               atol=1e-6)


def test_bunny_scene_raises():
    with pytest.raises(NotImplementedError):
        tscene.make_scene([tscene.ObjectSpec(tsdf.SHAPE.BUNNY)])
