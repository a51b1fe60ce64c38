"""Shared setup for the PyTorch port's tests (``tests/test_torch_*.py``).

Importing this module caps PyTorch at one thread: the suite runs under
several xdist workers, and PyTorch's default of one thread per core would
oversubscribe the machine. It imports no jax, so the kernel tests can run
on a machine that has only PyTorch. The port's constructors build on the
card unless told otherwise, so the CPU tests pass ``CPU``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def tt(x, dtype=None) -> torch.Tensor:
    """numpy / array-like -> CPU tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def nn(x) -> np.ndarray:
    """tensor or array-like -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_rays(n: int, seed: int = 0, center=(0.0, 0.0, 3.5),
                spread: float = 0.2):
    """Rays from a jittered eye point in random directions (numpy f32)."""
    rng = np.random.default_rng(seed)
    o = np.asarray(center) + rng.normal(0, spread, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def chained_resumes(scene, o, d, cfg, budgets, active=None):
    """``ops/march.march_resumable`` over ``budgets`` trips a call, as the
    wavefront's split carry and the megakernel's ``alive`` gate chain it:
    a lane done, or gated off at entry, sits out the later calls and
    echoes its state; it keeps its ``index`` and ``hit``, and ``fin`` is
    summed over the calls. One kernel launch a call on the card."""
    from raytracingpbr_tpu_torch.ops import march as tmarch
    out = None
    for b in budgets:
        rr = tmarch.march_resumable(
            scene, o, d, cfg.replace(max_raymarch=b), active=active,
            init=None if out is None else (out.t, out.w, out.s, out.d))
        if out is not None:
            rr = rr._replace(index=torch.where(active, rr.index, out.index),
                             hit=torch.where(active, rr.hit, out.hit),
                             fin=out.fin + rr.fin)
        out = rr
        active = out.done == 0
    return out


def mixed_analytic_scene(device, plane=True):
    """Every analytic shape under the identity, signed permutations keyed
    by each axis (90 and 180 degree turns) and arbitrary rotations; a NONE;
    two copies of one box, the earlier one forced onto the matrix path
    (``rot_perm`` None on an exact permutation matrix), so that the two tie
    across K1a/K1b's object groups. ``plane=False`` leaves out the two
    planes (the escape bound needs a bounded scene)."""
    from raytracingpbr_tpu_torch.ops.scene import ObjectSpec, make_scene
    from raytracingpbr_tpu_torch.ops.sdf import SHAPE as S
    objs = [ObjectSpec(S.NONE)]
    if plane:
        objs += [ObjectSpec(S.PLANE, (0, -1.2, 0), (0, 0, 0), (1, 0.0, 1)),
                 ObjectSpec(S.PLANE, (0, 0.3, 0), (90, 0, 0), (1, 0.4, 1))]
    turns = [(0, 0, 0), (90, 0, 0), (0, 90, 0), (0, 0, 90), (180, 0, 0),
             (90, 90, 0), (0, -90, 90), (17, 35, -20)]
    for k, rot in enumerate(turns):
        c = (0.4 * np.cos(k), 0.1 * k - 0.3, 0.4 * np.sin(k))
        objs += [ObjectSpec(S.SPHERE, c, rot, (0.2 + 0.01 * k,) * 3),
                 ObjectSpec(S.BOX, c, rot, (0.3, 0.2 - 0.01 * k, 0.25)),
                 ObjectSpec(S.CYLINDER, c, rot, (0.2, 0.3 + 0.01 * k, 0.2)),
                 ObjectSpec(S.CONE, c, rot, (0.8, 0.6, 0.6 - 0.01 * k))]
    objs.append(ObjectSpec(S.BOX, (0.5, 0.5, 0.5), (0, 90, 0),
                           (0.3, 0.2, 0.1)))
    objs.append(objs[-1])
    scene = make_scene(objs, box_round=0.03, device=device)
    twin = [i for i, t in enumerate(scene.shape_types) if t == S.BOX][-2:]
    perm = list(scene.rot_perm)
    perm[twin[0]] = None
    return scene.replace(rot_perm=tuple(perm))


def many_objects_scene(device, n=128, seed=0):
    """``n`` analytic objects (no plane) in a unit cube: spheres, boxes,
    cylinders and cones, half turned by multiples of 90 degrees (signed
    permutations), the rest by arbitrary angles, every fifth a copy of the
    one before."""
    from raytracingpbr_tpu_torch.ops.scene import ObjectSpec, make_scene
    from raytracingpbr_tpu_torch.ops.sdf import SHAPE as S
    rng = np.random.default_rng(seed)
    shapes = (S.SPHERE, S.BOX, S.CYLINDER, S.CONE)
    objs = []
    for k in range(n):
        if k % 5 == 4:
            objs.append(objs[-1])
            continue
        rot = (tuple(90.0 * rng.integers(-2, 3, 3)) if k % 2 else
               tuple(rng.uniform(-180, 180, 3)))
        objs.append(ObjectSpec(shapes[k % 4], tuple(rng.uniform(-1, 1, 3)),
                               rot, tuple(rng.uniform(0.05, 0.15, 3))))
    return make_scene(objs, box_round=0.01, device=device)


def bunny_beside_shapes(device):
    """The bunny (last, as ``make_scene`` sorts by shape type) beside a
    sphere, a box, a cylinder and a cone."""
    from raytracingpbr_tpu_torch.ops.scene import ObjectSpec, make_scene
    from raytracingpbr_tpu_torch.ops.sdf import SHAPE as S
    return make_scene([
        ObjectSpec(S.BUNNY, (0, 0, 0), (-90, 0, 0), (1, 1, 1)),
        ObjectSpec(S.SPHERE, (0.9, 0.2, 0.0), (0, 0, 0), (0.3,) * 3),
        ObjectSpec(S.BOX, (-0.9, -0.3, 0.2), (10, 30, 0), (0.25, 0.2, 0.3)),
        ObjectSpec(S.CYLINDER, (0.0, -0.9, 0.3), (0, 0, 90),
                   (0.2, 0.3, 0.2)),
        ObjectSpec(S.CONE, (0.2, 0.9, -0.3), (17, 35, -20),
                   (0.8, 0.6, 0.5))], device=device)


def golden_psnr(name: str) -> float:
    """The port's render of golden ``name`` (``models/goldens``, on the
    CPU) scored against ``assets/goldens/<name>.png``, in dB."""
    import os

    from raytracingpbr_tpu_torch.io.image import read_png
    from raytracingpbr_tpu_torch.models.goldens import render_golden
    from raytracingpbr_tpu_torch.utils.metrics import psnr
    img = render_golden(name, CPU)
    gold = read_png(os.path.join(os.path.dirname(__file__), "..", "assets",
                                 "goldens", f"{name}.png"))[..., :3]
    got = (np.clip(nn(img), 0, 1) * 255 + 0.5).astype(np.uint8)
    assert got.shape == gold.shape
    return psnr(got, gold)


# --- the analytic normal's cases (calc_normal_closed_plain, the kernel) ----

# object poses: Euler degrees, or "animated" (the general pose, then
# ``scene.animate``: a turned matrix and a non-zero ``local_offset``)
NORMAL_POSES = {"identity": (0, 0, 0), "permutation": (90, 0, 180),
                "turned": (0, -90, 90), "cornell": (0, -253, 0),
                "general": (17, -197, 35), "animated": (17, -197, 35)}


def _normal_lattice(shape, s):
    """Local points of one object where the gradient's ties and zeros
    lie, exact in float32 (dyadic scales): a box's faces, edges and
    corners on, inside and outside its surface (``amax`` ties, ``|p| = 0``
    planes); a cylinder's rim, wall, caps and axis; a cone's apex, axis
    and the point where its two planes tie; a sphere's centre (the
    ``safe_norm`` at 0) and axes."""
    from raytracingpbr_tpu_torch.ops.sdf import SHAPE as S
    t = np.array([-0.125, 0.0, 0.0625])
    sign = np.array([-1.0, 1.0])
    pts = []
    if shape == S.BOX:
        c = np.array([-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5])
        pts += [np.array(v) * s for v in np.stack(np.meshgrid(
            c, c, c, indexing="ij"), -1).reshape(-1, 3)]
        for dt in t:
            for sx in sign:
                for sy in sign:
                    for sz in sign:
                        f = np.array([sx, sy, sz])
                        pts.append(f * (s + dt))  # 3-way ties
                        pts.append(f * (s + [dt, dt, -0.25]))  # 2-way
    elif shape == S.CYLINDER:
        r, h = s[0], s[1]
        for dr in (-r, *t, 0.5):
            for dy in (-h, *t, 0.5):
                for sx in sign:
                    for sy in sign:
                        pts.append([sx * (r + dr), sy * (h + dy), 0.0])
                        pts.append([0.0, sy * (h + dy), sx * (r + dr)])
        pts += [[0.0, y, 0.0] for y in (-0.5, 0.0, 0.125, h, 0.5)]
    elif shape == S.CONE:
        # s = (0.5, 0.5, 1.0): on the axis the planes tie at y = -0.25
        pts += [[0.0, y, 0.0] for y in (-0.5, -0.25, 0.0, 0.25)]
        pts += [[x, -0.25, z] for x in (-0.5, 0.0, 0.5)
                for z in (-0.25, 0.0, 0.25)]
    elif shape == S.SPHERE:
        pts += [[0.0, 0.0, 0.0]] + [list(v * s[0] * k) for v in np.eye(3)
                                    for k in (-1.5, 1.0, 0.5)]
    return np.array(pts, dtype=np.float64).reshape(-1, 3)


def normal_scene(pose: str, box_round: float, device):
    """Every analytic shape (NONE first, two boxes) in one pose, for the
    analytic normal: each object is a shape bucket's own or one of two,
    and every other object's gradient flows beside the lane's own."""
    from raytracingpbr_tpu_torch.ops.scene import (ObjectSpec, animate,
                                                    make_scene)
    from raytracingpbr_tpu_torch.ops.sdf import SHAPE as S
    rot = NORMAL_POSES[pose]
    scene = make_scene([
        ObjectSpec(S.NONE),
        ObjectSpec(S.SPHERE, (0.5, 0.25, 0.0), rot, (0.375,) * 3),
        ObjectSpec(S.BOX, (-0.5, 0.0, 0.25), rot, (0.5, 0.25, 0.375)),
        ObjectSpec(S.BOX, (0.0, 0.5, -0.5), rot, (0.25, 0.125, 0.25)),
        ObjectSpec(S.CYLINDER, (0.25, -0.5, 0.5), rot, (0.5, 0.25, 0.5)),
        ObjectSpec(S.CONE, (-0.25, 0.75, 0.0), rot, (0.5, 0.5, 1.0)),
        ObjectSpec(S.PLANE, (0.0, -1.0, 0.0), rot, (1.0, 0.25, 1.0)),
    ], box_round=box_round, device=device)
    return animate(scene, 37) if pose == "animated" else scene


def normal_points(scene, n_random: int, seed: int = 0):
    """(idx int32, p float32) CPU tensors for the analytic normal: each
    object's :func:`_normal_lattice` taken to the world frame (exact under
    the identity and signed permutations), ``n_random`` lanes of random
    objects at points about them, missed lanes (far points, ``MAX_DIS``
    away) of every object, and two NaN points."""
    rng = np.random.default_rng(seed)
    pos = scene.position.double().cpu().numpy()
    mat = scene.matrix.double().cpu().numpy()
    off = scene.local_offset.double().cpu().numpy()
    scale = scene.scale.double().cpu().numpy()
    idx, pts = [], []
    for i, shape in enumerate(scene.shape_types):
        local = _normal_lattice(shape, scale[i])
        idx += [i] * len(local)
        pts.append(pos[i] + (local - off[i]) @ mat[i])
    k = rng.integers(0, scene.num_objects, n_random)
    idx += list(k)
    pts.append(pos[k] + rng.normal(0, 0.6, (n_random, 3)))
    far = rng.normal(size=(scene.num_objects, 3))
    far *= 1e3 / np.linalg.norm(far, axis=-1, keepdims=True)
    idx += list(range(scene.num_objects)) + [0, scene.num_objects - 1]
    pts += [far, np.full((2, 3), np.nan)]
    return (torch.as_tensor(np.array(idx), dtype=torch.int32),
            torch.as_tensor(np.concatenate(pts).astype(np.float32)))


def assert_normals_bit_equal(got: torch.Tensor, want: torch.Tensor):
    """Every lane's three components bit for bit: the same float or both
    NaN, and the same sign (a zero's too)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    same = ((got == want) & (torch.signbit(got) == torch.signbit(want))
            | (nan & torch.isnan(got)))
    bad = ~same.all(-1)
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} lanes differ; first "
        f"{torch.nonzero(bad)[:4, 0].tolist()}")
