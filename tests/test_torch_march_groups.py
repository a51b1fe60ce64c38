"""K1a/K1b's object groups (``kernels/march_kernel.pack_groups``) on the
CPU, against the plain version's geometry, and the port's plain march
against the JAX march on every model scene.

The kernels' arithmetic is mirrored here in PyTorch on the CPU, where every
f32 operation rounds on its own as on the card with ``-fmad=false``: each
record's distance (``csrc/march.cu::object_sd``) from the grouped pack must
equal ``ops/scene.all_distances`` in absolute value bit for bit (a signed
permutation may flip the sign of an exact zero, which no caller reads), and
the kernel's fold (a lexicographic (distance, index) running min over the
records in group order, and on points with a NaN or an infinite
coordinate the spheres alone) must equal ``ops/scene.nearest`` in index
and distance. Against JAX the bars are
``tests/test_pallas.py``'s: at least 99.9% hit agreement, t within rtol
1e-3 where hit agrees, equal index where both hit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu_torch.convert import config_from_jax, scene_from_jax
from raytracingpbr_tpu_torch.kernels import march_kernel
from raytracingpbr_tpu_torch.models import cornell as tcornell
from raytracingpbr_tpu_torch.models import demo as tdemo
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops import sdf as tsdf
from raytracingpbr_tpu_torch.ops.scene import ObjectSpec, make_scene
from raytracingpbr_tpu_torch.ops.sdf import SHAPE

from .test_torch_march import _assert_march_bars
from .torch_helpers import (CPU, bunny_beside_shapes, many_objects_scene,
                            mixed_analytic_scene, nn, random_rays, tt)

F32 = torch.float32


def _offset(scene):
    off = np.random.default_rng(5).normal(0, 0.05, (scene.num_objects, 3))
    return scene.replace(local_offset=tt(off.astype(np.float32)))


SCENES = {
    "cornell_full": lambda: tcornell.full_scene(CPU),
    "cornell_minimal": lambda: tcornell.minimal_scene(CPU),
    "cornell_v2": lambda: tcornell.v2_scene(CPU),
    "engine": lambda: tdemo.engine_scene(CPU),
    "scene_demo": lambda: tdemo.scene_demo_scene(CPU),
    "mixed": lambda: mixed_analytic_scene(CPU),
    "mixed_offset": lambda: _offset(mixed_analytic_scene(CPU)),
    "mixed_baked": lambda: tscene.bake(mixed_analytic_scene(CPU)),
    "many_objects": lambda: many_objects_scene(CPU),
}


def _points(scene, n=3000, seed=0):
    """Seeded points about the scene; a third of them share a coordinate
    with an object's position exactly, so that x - pos is an exact zero,
    and some lie on axis planes (a zero coordinate)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    pos = nn(scene.position)
    obj = rng.integers(0, scene.num_objects, n)
    axis = rng.integers(0, 3, n)
    pick = rng.random(n) < 0.33
    p[pick, axis[pick]] = pos[obj[pick], axis[pick]]
    zero = rng.random(n) < 0.1
    p[zero, axis[zero]] = 0.0
    return tt(p)


def _sd_shape(shape, px, py, pz, sx, sy, sz, box_round):
    """``csrc/march_common.cuh::sd_shape``, every operation in its order."""
    z = torch.zeros((), dtype=F32)
    if shape == SHAPE.SPHERE:
        return torch.sqrt(px * px + py * py + pz * pz) - sx
    if shape == SHAPE.BOX:
        qx, qy, qz = px.abs() - sx, py.abs() - sy, pz.abs() - sz
        ox, oy, oz = (torch.maximum(q, z) for q in (qx, qy, qz))
        outside = torch.sqrt(ox * ox + oy * oy + oz * oz)
        inside = torch.minimum(torch.maximum(qx, torch.maximum(qy, qz)), z)
        return outside + inside - box_round
    if shape == SHAPE.CYLINDER:
        dx = torch.sqrt(px * px + pz * pz).abs() - sx
        dy = py.abs() - sy
        mx, my = torch.maximum(dx, z), torch.maximum(dy, z)
        return (torch.minimum(torch.maximum(dx, dy), z)
                + torch.sqrt(mx * mx + my * my))
    if shape == SHAPE.CONE:
        q = torch.sqrt(px * px + pz * pz)
        return torch.maximum(sx * q + sz * py, -sy - py)
    assert shape == SHAPE.PLANE
    return py - sy


def _record_sd(shape, xf, r, p, box_round):
    """``csrc/march.cu::object_sd`` of one record ``r`` (RECORD floats) of a
    ``shape`` with transform ``xf`` at points ``p`` (N, 3)."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    a0, a1, a2, a3 = r[7], r[8], r[9], r[10]
    if xf == march_kernel.XF_MATRIX:
        t = (x - r[0], y - r[1], z - r[2])
        px, py, pz = (r[12 + 4 * k] * t[0] + r[13 + 4 * k] * t[1]
                      + r[14 + 4 * k] * t[2] + r[4 + k] for k in range(3))
        return _sd_shape(shape, px, py, pz, a0, a1, a2, box_round)
    u = [(x - r[0]) + r[4], (y - r[1]) + r[5], (z - r[2]) + r[6]]
    s = [a0, a1, a2]
    i, j = [a for a in range(3) if a != xf]
    zero = torch.zeros((), dtype=F32)
    if shape == SHAPE.BOX:
        return _sd_shape(shape, u[i], u[j], u[xf], s[i], s[j], s[xf],
                         box_round)
    if shape == SHAPE.CYLINDER:
        return _sd_shape(shape, u[i], u[xf], u[j], a0, a1, zero, box_round)
    if shape == SHAPE.CONE:
        return _sd_shape(shape, u[i], a3 * u[xf], u[j], a0, a1, a2,
                         box_round)
    if shape == SHAPE.PLANE:
        return _sd_shape(shape, zero, u[xf], zero, zero, a1, zero,
                         box_round)
    return _sd_shape(shape, u[i], u[j], u[xf], a0, zero, zero, box_round)


_SHAPES = (SHAPE.SPHERE, SHAPE.BOX, SHAPE.CYLINDER, SHAPE.CONE, SHAPE.PLANE)


def _groups(scene):
    """The records and the table's groups of ``pack_groups``, and the runs
    the kernel walks: (kind, shape, transform, first record, end record)."""
    params, table = march_kernel.pack_groups(scene)
    rec = params[4:].reshape(-1, march_kernel.RECORD)
    t = nn(table)
    groups = [tuple(int(v) for v in row) for row in t[1:1 + t[0, 0]]]
    runs, start = [], 0
    for kind, e0, e1, e2 in groups:
        shape = _SHAPES[kind // 2]
        if kind % 2:
            runs.append((kind, shape, march_kernel.XF_MATRIX, start, e2))
        else:
            runs += [(kind, shape, 0, start, e0), (kind, shape, 1, e0, e1),
                     (kind, shape, 2, e1, e2)]
        start = e2
    return rec, groups, runs


@pytest.mark.parametrize("case", sorted(SCENES))
def test_group_order_covers_each_object_once(case):
    scene = SCENES[case]()
    groups, order, _, _ = march_kernel.group_layout(scene.shape_types,
                                                    scene.rot_perm)
    want = [i for i, t in enumerate(scene.shape_types) if t != SHAPE.NONE]
    assert sorted(order) == want
    assert [g[0] for g in groups] == sorted({g[0] for g in groups})
    rec, table_groups, runs = _groups(scene)
    assert table_groups == list(groups)
    assert (runs[-1][4] if runs else 0) == len(order)
    covered = []
    for kind, shape, xf, b, e in runs:
        members = order[b:e]
        assert list(members) == sorted(members)  # index order in a run
        for i in members:
            t, perm = scene.shape_types[i], scene.rot_perm[i]
            assert march_kernel.group_kind(t, perm) == kind
            assert t == shape and march_kernel.transform(t, perm) == xf
        covered += list(members)
    assert sorted(covered) == want
    np.testing.assert_array_equal(nn(rec[:len(order), 3]), order)
    assert (nn(rec[len(order):]) == 0).all()
    if case == "mixed_baked":
        assert all(g[0] % 2 == 1 for g in groups)


def test_model_scenes_group_kinds():
    """Cornell's 6 permutation boxes key on all three axes (one group, three
    runs) and its two rotated boxes take the matrix; every object of engine
    and scene_demo is a permutation (the identity)."""
    _, groups, runs = _groups(SCENES["cornell_full"]())
    assert [g[0] for g in groups] == [2, 3]  # box: permutation, matrix
    assert [(xf, e - b) for _, _, xf, b, e in runs] == [
        (0, 2), (1, 3), (2, 1), (march_kernel.XF_MATRIX, 2)]
    for case in ("engine", "scene_demo"):
        assert all(g[0] % 2 == 0 for g in _groups(SCENES[case]())[1])


@pytest.mark.parametrize("case", sorted(SCENES))
def test_record_distances_bit_equal_to_plain(case):
    """Each record's distance, in the kernel's order of operations, equals
    the plain version's |sd| bit for bit, exact zeros of x - pos included."""
    scene = SCENES[case]()
    p = _points(scene, seed=len(case))
    rec, _, runs = _groups(scene)
    box_round = torch.tensor(scene.box_round, dtype=F32)
    want = tscene.all_distances(scene, p).abs()
    zeros = 0
    for _, shape, xf, b, e in runs:
        for j in range(b, e):
            obj = int(rec[j, 3])
            got = _record_sd(shape, xf, rec[j], p, box_round).abs()
            np.testing.assert_array_equal(nn(got), nn(want[:, obj]),
                                          err_msg=f"record {j}, {shape} {xf}")
            zeros += int((p - scene.position[obj] == 0).sum())
    assert zeros > 100


@pytest.mark.parametrize("case", ["cornell_full", "mixed", "mixed_offset",
                                  "many_objects"])
def test_permutation_records_equal_to_object_space(case):
    """A permutation record's u_a = (x_a - pos_a) + offset_a, times the sign
    of row r reading axis a = c_r, is ``sdf.to_object_space``'s row r bit
    for bit (an exact zero may differ in sign)."""
    scene = SCENES[case]()
    p = _points(scene, seed=5)
    rec, _, runs = _groups(scene)
    checked = zeros = 0
    for _, _, xf, b, e in runs:
        if xf == march_kernel.XF_MATRIX:
            continue
        for j in range(b, e):
            obj = int(rec[j, 3])
            cols, signs = scene.rot_perm[obj]
            u = [(p[:, a] - rec[j, a]) + rec[j, 4 + a] for a in range(3)]
            want = tsdf.to_object_space(p, scene.position[obj],
                                        scene.matrix[obj],
                                        scene.local_offset[obj])
            for r in range(3):
                got = signs[r] * u[cols[r]]
                assert bool((got == want[:, r]).all()), (case, obj, r)
                zeros += int((want[:, r] == 0).sum())
            checked += 1
    assert checked >= 4
    assert zeros > 0 or case == "mixed_offset"  # offsets move the zeros


def _non_finite(p):
    """``p`` with one coordinate of each point NaN, +inf or -inf."""
    bad = torch.tensor([float("nan"), float("inf"), -float("inf")])
    p = p.clone()
    k = torch.arange(p.shape[0])
    p[k, k % 3] = bad[k % 3]
    return p


# the non-finite points' cases: the analytic scenes, and the bunny beside
# every analytic shape (K1c and K1d's ``nearest_non_finite``)
NON_FINITE_SCENES = {**SCENES,
                     "bunny_beside_shapes": lambda: bunny_beside_shapes(CPU)}


@pytest.mark.parametrize("case", sorted(NON_FINITE_SCENES))
def test_non_finite_points_reach_spheres_only(case):
    """Where a point has a NaN or an infinite coordinate, the plain
    version's local coordinates are each NaN or infinite (0 * inf and
    m * NaN in the matrix products), so every SDF but the sphere's is NaN
    or infinite; the sphere's is -sx where a coordinate is NaN (its
    ``safe_norm`` maps NaN to 0). The bunny's, in K1c's order and in the
    matmul form, is never under 1e30 either: a NaN point passes the support
    test into the MLP, which gives NaN. ``fold_non_finite`` (K1a, K1b) and
    ``nearest_non_finite`` (K1c, K1d) rest on this."""
    scene = NON_FINITE_SCENES[case]()
    p = _non_finite(_points(scene, n=300, seed=2))
    for kernel_order in (False, True):
        d = tscene.all_distances(scene, p, kernel_order).abs()
        for i, t in enumerate(scene.shape_types):
            if t == SHAPE.SPHERE:
                ok = (d[:, i] == scene.scale[i, 0].abs()) | ~(d[:, i] < 1e30)
            elif t == SHAPE.NONE:
                ok = d[:, i] == 1e3  # never under MAX_DIS
            else:
                ok = ~(d[:, i] < 1e30)
            assert bool(ok.all()), (case, i, t, kernel_order)
    if case == "bunny_beside_shapes":
        assert SHAPE.BUNNY in scene.shape_types
        assert bool((d[:, 0] == scene.scale[0, 0]).any())


def _group_fold(scene, p):
    """The kernel's fold: the running min over (distance, object index),
    lexicographic, from (1e3, 0), record by record in group order. At a
    finite point each record's distance (``object_sd``); at a point with a
    NaN or an infinite coordinate only the spheres whose matrix products
    have a NaN, each at |0 - sx| (``fold_non_finite``)."""
    rec, _, runs = _groups(scene)
    box_round = torch.tensor(scene.box_round, dtype=F32)
    finite = torch.isfinite(p).all(dim=-1)
    best = torch.full((p.shape[0],), 1e3, dtype=F32)
    idx = torch.zeros((p.shape[0],), dtype=torch.int32)
    for kind, shape, xf, b, e in runs:
        for j in range(b, e):
            r = rec[j]
            d = _record_sd(shape, xf, r, p, box_round).abs()
            if kind < 2:  # a sphere: visited at non-finite points too
                t = (p[:, 0] - r[0], p[:, 1] - r[1], p[:, 2] - r[2])
                nan = torch.zeros_like(finite)
                for k in range(3):
                    nan |= (r[12 + 4 * k] * t[0] + r[13 + 4 * k] * t[1]
                            + r[14 + 4 * k] * t[2]).isnan()
                d = torch.where(finite, d, torch.where(
                    nan, (0.0 - r[7]).abs(), torch.nan))
            else:
                d = torch.where(finite, d, torch.nan)
            take = (d < best) | ((d == best) & (int(r[3]) < idx))
            best = torch.where(take, d, best)
            idx = torch.where(take, int(r[3]), idx)
    return idx, best


@pytest.mark.parametrize("case", sorted(SCENES))
def test_group_fold_equals_nearest(case):
    """Index and distance equal ``scenelib.nearest`` (the ordered strict <
    from 1e3): on points near the scene, on far points (where every
    distance is at least 1e3 without a plane or a cone: index 0), and on
    the mixed scene's twin boxes, whose equal distances come from two
    groups."""
    scene = SCENES[case]()
    p = _points(scene, seed=7)
    far = tt(np.random.default_rng(8).normal(0, 1, (64, 3)).astype(
        np.float32) * 1e4)
    p = torch.cat([_non_finite(p[:32]), p, far])
    idx, best = _group_fold(scene, p)
    want_idx, want_best = tscene.nearest(scene, p)
    np.testing.assert_array_equal(nn(idx), nn(want_idx))
    np.testing.assert_array_equal(nn(best), nn(want_best))
    if not {SHAPE.PLANE, SHAPE.CONE} & set(scene.shape_types):
        # nothing unbounded: every far distance is at least 1e3
        assert (nn(best)[-64:] == np.float32(1e3)).all()
        assert (nn(idx)[-64:] == 0).all()
    if case == "mixed":
        twin = [i for i, t in enumerate(scene.shape_types)
                if t == SHAPE.BOX][-2:]
        d = tscene.all_distances(scene, p).abs()
        tie = (d[:, twin[0]] == d[:, twin[1]]) & (idx == twin[0])
        assert int(tie.sum()) > 10  # the earlier twin won its ties


def test_fold_of_duplicated_objects():
    """Copies of one sphere in one group, and of one box split over two
    groups: the first copy wins every tie."""
    spec = ObjectSpec(SHAPE.SPHERE, (0.1, 0.2, 0.3), (0, 0, 0), (0.4,) * 3)
    box = ObjectSpec(SHAPE.BOX, (0.0, -0.2, 0.1), (0, 90, 0), (0.3, 0.2, 0.1))
    scene = make_scene([spec, box, spec, box, spec], device=CPU)
    perm = list(scene.rot_perm)
    perm[4] = None  # the later box on the matrix path
    scene = scene.replace(rot_perm=tuple(perm))
    p = _points(scene, seed=3)
    idx, best = _group_fold(scene, p)
    want_idx, want_best = tscene.nearest(scene, p)
    np.testing.assert_array_equal(nn(idx), nn(want_idx))
    np.testing.assert_array_equal(nn(best), nn(want_best))
    assert set(np.unique(nn(idx))) <= {0, 3}


def test_pack_header_and_bound():
    scene = SCENES["engine"]()
    bound2 = torch.tensor(7.5, dtype=F32)
    params, table = march_kernel.pack_groups(scene, bound2)
    assert params.shape == (4 + scene.num_objects * march_kernel.RECORD,)
    assert nn(params[:4]).tolist() == [7.5, 0.0, 0.0, 0.0]
    assert table.shape == (1 + march_kernel.MAX_GROUPS, 4)
    assert table.dtype == torch.int32
    assert float(march_kernel.pack_groups(scene)[0][0]) == 0.0


JAX_SCENES = {
    "cornell_full": (jcornell.full_scene, jcornell.full_config, 0.5),
    "cornell_minimal": (jcornell.minimal_scene, jcornell.minimal_config,
                        0.5),
    "cornell_v2": (jcornell.v2_scene, jcornell.v2_config, 0.5),
    "cornell_v3": (jcornell.full_scene, jcornell.v3_config, 0.5),
    "engine": (jdemo.engine_scene, jdemo.engine_config, 3.5),
    "scene_demo": (jdemo.scene_demo_scene, jdemo.scene_demo_config, 3.5),
}


@pytest.mark.parametrize("case", sorted(JAX_SCENES))
def test_plain_march_matches_jax_on_model_scenes(case):
    """The plain march the kernels are held to, against the JAX march on
    each model scene (the XLA path, as ``tests/test_torch_march.py``)."""
    make, make_cfg, z = JAX_SCENES[case]
    js, jcfg = make(), make_cfg().replace(max_raymarch=96)
    o, d = random_rays(1024, seed=11, center=(0.0, 0.0, z), spread=0.2)
    ref = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), jcfg,
                       differentiable=False, backend="xla")
    got = tmarch.march(scene_from_jax(js, CPU), tt(o), tt(d),
                       config_from_jax(jcfg))
    _assert_march_bars(ref, got)
    assert nn(got.hit).mean() > 0.2
