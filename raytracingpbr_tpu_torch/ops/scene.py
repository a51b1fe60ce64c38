"""Scene representation and geometry queries (port of
``raytracingpbr_tpu/ops/scene.py``).

``Scene`` is an ``nn.Module`` whose per-object tensors are buffers, so
``scene.to(device)`` moves it; its static metadata (``shape_types``,
``type_splits``, ``bucket_types``, ``box_round``, ``rot_perm``) are plain
attributes. Objects are sorted by shape type and evaluated bucket by bucket,
as in the JAX package. A scene with a BUNNY object carries the MLP weights
as ``bunny_*`` buffers (``scene.bunny``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.autograd.function import once_differentiable

from ..core.device import resolve
from ..core.math import rotate_euler, safe_norm
from ..kernels import material_grad_kernel, normal_kernel
from . import sdf as sdflib
from .sdf import SHAPE, BunnyMLP

MAX_DIS = sdflib.MAX_DIS


@dataclasses.dataclass
class ObjectSpec:
    """Host-side object description with the 6-parameter material."""

    shape: SHAPE
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # Euler degrees
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    emission: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    roughness: float = 1.0
    metallic: float = 0.0
    transmission: float = 0.0
    ior: float = 1.0


_BUFFERS = ("position", "rotation", "scale", "matrix", "local_offset",
            "albedo", "emission", "roughness", "metallic", "transmission",
            "ior")
# the buffers the signed distance reads (``rotation`` only through a
# re-baked ``matrix``)
_SDF_BUFFERS = ("position", "scale", "matrix", "local_offset")


class Scene(nn.Module):
    """Struct-of-arrays scene: (n, ...) buffers over objects plus static
    metadata. ``rot_perm[i]`` is None or ``((p0, p1, p2), (s0, s1, s2))``:
    row r of object i's matrix is ``s_r * e_{p_r}`` (a signed
    permutation)."""

    def __init__(self, shape_types, type_splits, bucket_types, box_round,
                 rot_perm, bunny: Optional[BunnyMLP] = None,
                 type_ids: Optional[torch.Tensor] = None, **tensors):
        super().__init__()
        if SHAPE.BUNNY in shape_types and bunny is None:
            raise ValueError("a scene with a BUNNY object needs the MLP "
                             "weights (sdf.load_bunny)")
        self.shape_types = tuple(int(t) for t in shape_types)
        self.type_splits = tuple(int(s) for s in type_splits)
        self.bucket_types = tuple(int(t) for t in bucket_types)
        self.box_round = float(box_round)
        self.rot_perm = tuple(rot_perm)
        for name in _BUFFERS:
            self.register_buffer(name, tensors[name])
        self.has_bunny = bunny is not None
        if bunny is not None:
            for name, v in zip(BunnyMLP._fields, bunny):
                self.register_buffer("bunny_" + name, v)
        # the shape types as a device array, for the CUDA march kernel
        # (``replace`` hands its own on: a new one is a copy to the card)
        if type_ids is None:
            type_ids = torch.tensor(self.shape_types, dtype=torch.int32,
                                    device=tensors["position"].device)
        self.register_buffer("type_ids", type_ids)

    @property
    def num_objects(self) -> int:
        return len(self.shape_types)

    @property
    def device(self) -> torch.device:
        return self.position.device

    @property
    def bunny(self) -> Optional[BunnyMLP]:
        if not self.has_bunny:
            return None
        return BunnyMLP(*(getattr(self, "bunny_" + k)
                          for k in BunnyMLP._fields))

    def replace(self, **kw) -> "Scene":
        """A new Scene with some buffers (or ``rot_perm``) replaced."""
        meta = dict(shape_types=self.shape_types,
                    type_splits=self.type_splits,
                    bucket_types=self.bucket_types, box_round=self.box_round,
                    rot_perm=self.rot_perm, bunny=self.bunny)
        meta.update({k: kw.pop(k) for k in list(kw) if k in meta})
        if meta["shape_types"] == self.shape_types:
            meta["type_ids"] = self.type_ids
        tensors = {name: getattr(self, name) for name in _BUFFERS}
        tensors.update(kw)
        return Scene(**meta, **tensors)


def param_names(scene: Scene) -> Tuple[str, ...]:
    """The names of the scene's float buffers, in a fixed order: the
    objects' (``_BUFFERS``), then the bunny's weights (``bunny_*``) when it
    has them. These are what gradients reach and an optimizer updates."""
    bunny = (tuple("bunny_" + k for k in BunnyMLP._fields)
             if scene.has_bunny else ())
    return _BUFFERS + bunny


def params(scene: Scene) -> Tuple[torch.Tensor, ...]:
    """The scene's float buffers in :func:`param_names`' order."""
    return tuple(getattr(scene, k) for k in param_names(scene))


def with_params(scene: Scene, tensors: Sequence[torch.Tensor]) -> Scene:
    """A new Scene with the buffers of :func:`params` replaced, in that
    order, by ``tensors`` (the same metadata, ``rot_perm`` included)."""
    names = param_names(scene)
    kw = dict(zip(names[:len(_BUFFERS)], tensors[:len(_BUFFERS)]))
    if scene.has_bunny:
        kw["bunny"] = BunnyMLP(*tensors[len(_BUFFERS):])
    return scene.replace(**kw)


def sdf_params(scene: Scene) -> Tuple[torch.Tensor, ...]:
    """The float buffers that the signed distance reads: the objects'
    transforms and scales (``_SDF_BUFFERS``), then the bunny's weights when
    it has them. No gradient reaches the hit point or the normal from any
    other buffer."""
    return (tuple(getattr(scene, k) for k in _SDF_BUFFERS)
            + tuple(scene.bunny or ()))


def with_sdf_params(scene: Scene, tensors: Sequence[torch.Tensor]) -> Scene:
    """A new Scene with the buffers of :func:`sdf_params` replaced, in that
    order, by ``tensors``."""
    kw = dict(zip(_SDF_BUFFERS, tensors[:len(_SDF_BUFFERS)]))
    if scene.has_bunny:
        kw["bunny"] = BunnyMLP(*tensors[len(_SDF_BUFFERS):])
    return scene.replace(**kw)


def _snap_and_classify(mats: np.ndarray, tol: float = 1e-6):
    """Snap near-{-1,0,1} matrix entries exactly and classify each rotation
    as a signed permutation where possible (see ``Scene``)."""
    mats = mats.copy()
    near = np.abs(mats - np.round(mats)) < tol
    mats[near] = np.round(mats[near])
    perms = []
    for m in mats:
        perm = None
        if np.all(np.isin(m, (-1.0, 0.0, 1.0))) and \
                np.all((m != 0).sum(axis=1) == 1) and \
                np.all((m != 0).sum(axis=0) == 1):
            cols = np.argmax(m != 0, axis=1)
            signs = m[np.arange(3), cols]
            perm = (tuple(int(c) for c in cols),
                    tuple(int(s) for s in signs))
        perms.append(perm)
    return mats, tuple(perms)


def bucket_layout(types: Sequence[int]):
    """(type_splits, bucket_types) of a type-sorted list."""
    splits = [0]
    bucket_types = []
    for i, t in enumerate(types):
        if not bucket_types or t != bucket_types[-1]:
            if bucket_types:
                splits.append(i)
            bucket_types.append(t)
    splits.append(len(types))
    return tuple(splits), tuple(bucket_types)


def make_scene(objects: Sequence[ObjectSpec], box_round: float = 0.03,
               device=None, dtype=torch.float32) -> Scene:
    """Build a Scene from specs: sort by shape type, bake and snap the
    rotation matrices."""
    device = resolve(device)
    objs = sorted(objects, key=lambda o: int(o.shape))
    types = tuple(int(o.shape) for o in objs)
    splits, bucket_types = bucket_layout(types)
    bunny = (sdflib.load_bunny(device, dtype) if SHAPE.BUNNY in types
             else None)

    def stack(get, tail=()):
        arr = np.array([get(o) for o in objs], dtype=np.float32)
        return torch.as_tensor(arr.reshape((len(objs),) + tail),
                               dtype=dtype, device=device)

    rotation = stack(lambda o: o.rotation, (3,))
    mats = sdflib.bake_matrices(rotation.cpu()).numpy()
    mats, rot_perm = _snap_and_classify(mats)
    return Scene(
        types, splits, bucket_types, box_round, rot_perm,
        position=stack(lambda o: o.position, (3,)),
        rotation=rotation,
        scale=stack(lambda o: o.scale, (3,)),
        matrix=torch.as_tensor(mats, dtype=dtype, device=device),
        local_offset=torch.zeros((len(objs), 3), dtype=dtype,
                                 device=device),
        albedo=stack(lambda o: o.albedo, (3,)),
        emission=stack(lambda o: o.emission, (3,)),
        roughness=stack(lambda o: o.roughness),
        metallic=stack(lambda o: o.metallic),
        transmission=stack(lambda o: o.transmission),
        ior=stack(lambda o: o.ior),
        bunny=bunny,
    )


def bake(scene: Scene) -> Scene:
    """Re-bake the rotation matrices from the Euler degrees (after a change
    of ``rotation``); the signed-permutation classification is dropped."""
    return scene.replace(matrix=sdflib.bake_matrices(scene.rotation),
                         rot_perm=(None,) * scene.num_objects)


def _sd_typed(scene: Scene, type_id: int, p_local, scale,
              kernel_order: bool = False):
    if type_id == SHAPE.BOX:
        return sdflib.sd_round_box(p_local, scale, scene.box_round)
    if type_id == SHAPE.BUNNY:
        if kernel_order:
            return sdflib.sd_bunny_unrolled(p_local[..., 0], p_local[..., 1],
                                            p_local[..., 2], scene.bunny)
        return sdflib.sd_bunny(p_local, scene.bunny)
    return sdflib.SHAPE_FUNC[SHAPE(type_id)](p_local, scale)


def all_distances(scene: Scene, p: torch.Tensor,
                  kernel_order: bool = False) -> torch.Tensor:
    """Signed distance from points ``p`` (..., 3) to every object ->
    (..., n), one static bucket of equal-typed objects at a time.
    ``kernel_order``: evaluate the bunny MLP in the march kernel's order
    (``sdf.sd_bunny_unrolled``) instead of with matmuls."""
    chunks = []
    for b, t in enumerate(scene.bucket_types):
        lo, hi = scene.type_splits[b], scene.type_splits[b + 1]
        pl = sdflib.to_object_space(p[..., None, :], scene.position[lo:hi],
                                    scene.matrix[lo:hi],
                                    scene.local_offset[lo:hi])
        chunks.append(_sd_typed(scene, t, pl, scene.scale[lo:hi],
                                kernel_order))
    return torch.cat(chunks, dim=-1)


def nearest(scene: Scene, p: torch.Tensor, kernel_order: bool = True):
    """Nearest object index (int32) and min |sd|, as a running minimum that
    starts at MAX_DIS with a strict ``<``.

    This is the march kernels' convention: the first object wins ties, the
    distance is clamped at MAX_DIS, and the index stays 0 on points where
    no distance is below MAX_DIS. (JAX's ``nearest`` takes an argmin and
    then clamps, so on such far points its index can differ; it agrees
    everywhere else.) ``kernel_order``: the bunny in K1c's order of
    operations; False, in the matmul form (K1d's plain version)."""
    d = torch.abs(all_distances(scene, p, kernel_order=kernel_order))
    best = torch.full(d.shape[:-1], MAX_DIS, dtype=d.dtype, device=d.device)
    idx = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
    for i in range(scene.num_objects):
        take = d[..., i] < best
        idx = torch.where(take, i, idx)
        best = torch.where(take, d[..., i], best)
    return idx, best


def sd_object(scene: Scene, idx: torch.Tensor, p: torch.Tensor):
    """Signed distance to the selected object ``idx`` (...,) per point."""
    d = all_distances(scene, p)
    return torch.gather(d, -1, idx.to(torch.int64)[..., None])[..., 0]


def bounding_radius(scene: Scene) -> Optional[torch.Tensor]:
    """Conservative origin-centred bounding radius of the scene (None with
    an unbounded PLANE); see the JAX function for the per-shape radii."""
    if SHAPE.PLANE in scene.shape_types:
        return None
    radii = []
    for i, t in enumerate(scene.shape_types):
        s0, s1, s2 = scene.scale[i, 0], scene.scale[i, 1], scene.scale[i, 2]
        if t == SHAPE.SPHERE:
            r = s0
        elif t == SHAPE.BOX:
            r = torch.sqrt(s0 * s0 + s1 * s1 + s2 * s2) + scene.box_round
        elif t == SHAPE.CYLINDER:
            r = torch.sqrt(s0 * s0 + s1 * s1)
        elif t == SHAPE.CONE:
            r = s1 * torch.sqrt(s0 * s0 + s2 * s2) / torch.clamp_min(s0, 1e-6)
        elif t == SHAPE.BUNNY:
            # the MLP's support is the unit sphere in local coordinates,
            # whatever the scale (sd_bunny ignores it)
            r = torch.ones_like(s0)
        else:  # SHAPE.NONE
            r = torch.zeros_like(s0)
        radii.append(r)
    r_obj = (torch.linalg.vector_norm(scene.position, dim=-1)
             + torch.linalg.vector_norm(scene.local_offset, dim=-1)
             + torch.stack(radii))
    return torch.amax(r_obj) * 1.05 + 0.1


def has_escape_bound(scene: Scene, cfg) -> bool:
    """Whether the march runs the escape-bound test: ``cfg.escape_bound``
    on a bounded scene (no PLANE)."""
    return cfg.escape_bound and SHAPE.PLANE not in scene.shape_types


def escape_bound2(scene: Scene, cfg) -> Optional[torch.Tensor]:
    """The squared bounding radius that the march's escape test compares
    against, or None without the test. The plain march and the kernel's
    packed scene both take it from here, so they compare against the same
    f32 value."""
    if not has_escape_bound(scene, cfg):
        return None
    bound = bounding_radius(scene)
    return bound * bound


class Materials(NamedTuple):
    albedo: torch.Tensor        # (..., 3)
    emission: torch.Tensor      # (..., 3)
    roughness: torch.Tensor     # (...,)
    metallic: torch.Tensor      # (...,)
    transmission: torch.Tensor  # (...,)
    ior: torch.Tensor           # (...,)


# materials_at's calls by route: the plain gather (no part of the table
# requires grad, or grad mode is off), or the Function whose backward sums
# each object's lanes (kernels/material_grad_kernel)
MATERIAL_ROUTES = {"plain_gather": 0, "function": 0}


def materials_at(scene: Scene, idx: torch.Tensor) -> Materials:
    """All six material parameters of object ``idx`` per lane: one gather
    from the packed (n_obj, 10) table (the TPU's one-hot matmul is a GPU
    gather, ``index_select``).

    Where autograd records (grad mode on, and a part requires grad) the
    gather is :class:`_MaterialGather`: the same values, a gradient only
    for the parts that require one, each object's sum over its lanes (on
    the card one call of ``csrc/material_grad.cu``, no atomics; on the CPU
    ``index_add_``, ``index_select``'s backward's bits), and the fields of
    the parts that need none marked non-differentiable. Otherwise it is
    the plain gather."""
    parts = (scene.albedo, scene.emission, scene.roughness, scene.metallic,
             scene.transmission, scene.ior)
    if torch.is_grad_enabled() and any(t.requires_grad for t in parts):
        MATERIAL_ROUTES["function"] += 1
        return Materials(*_MaterialGather.apply(idx, *parts))
    MATERIAL_ROUTES["plain_gather"] += 1
    return _gather(parts, idx)


def _gather(parts, idx: torch.Tensor) -> Materials:
    """The six parts' rows of ``idx``: ``index_select`` on their (n_obj,
    10) concatenation, each field a slice of the gathered rows."""
    albedo, emission, roughness, metallic, transmission, ior = parts
    table = torch.cat([albedo, emission, roughness[:, None],
                       metallic[:, None], transmission[:, None],
                       ior[:, None]], -1)
    m = table.index_select(0, idx.reshape(-1).to(torch.int64)).reshape(
        idx.shape + (10,))
    return Materials(m[..., 0:3], m[..., 3:6], m[..., 6], m[..., 7],
                     m[..., 8], m[..., 9])


class _MaterialGather(torch.autograd.Function):
    """:func:`_gather` with the material gradient's own backward. Inputs:
    the lane indices and the six parts; outputs: the six fields. Saves the
    index alone. The fields of parts that need no gradient are
    non-differentiable, as gathering each part on its own would make
    them, so no graph runs from them: with an albedo leaf alone, the
    sampled direction (which reads the roughness) needs no gradient."""

    @staticmethod
    def forward(ctx, idx, *parts):
        out = _gather(parts, idx)
        needs = ctx.needs_input_grad[1:]
        ctx.save_for_backward(idx)
        ctx.num_objects = parts[0].shape[0]
        ctx.dtype = parts[0].dtype
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(f for f, need in zip(out, needs)
                                      if not need))
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        return (None,) + material_grad_kernel.material_grad(
            idx, grads, ctx.needs_input_grad[1:], ctx.num_objects, ctx.dtype)


# calc_normal's calls by route: the CUDA kernel (csrc/normal.cu), or
# autograd's first- or second-order gradient
NORMAL_ROUTES = {"kernel": 0, "autograd_first_order": 0,
                 "autograd_second_order": 0}


def calc_normal(scene: Scene, idx: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """Analytic surface normal: normalized gradient of ``sd_object`` with
    respect to ``p``.

    Where autograd records (grad mode on, and ``p`` or a buffer the SDF
    reads requires grad) it is :func:`calc_normal_autograd`'s second-order
    normal, differentiable in ``p`` and in the geometry as ``jax.grad``'s
    normal is. Otherwise it is first order, the forward render's numbers:
    on float32 CUDA points one launch of the normal kernel
    (``kernels/normal_kernel``, bit-equal to autograd's; on a scene with
    the BUNNY its instance with the sin-MLP's gradient written out), else
    (the CPU, other dtypes) autograd's first-order normal."""
    sdf_reads = (scene.position, scene.scale, scene.matrix,
                 scene.local_offset) + tuple(scene.bunny or ())
    if torch.is_grad_enabled() and (
            p.requires_grad or any(t.requires_grad for t in sdf_reads)):
        NORMAL_ROUTES["autograd_second_order"] += 1
        return calc_normal_autograd(scene, idx, p, create_graph=True)
    if p.is_cuda and p.dtype == torch.float32:
        NORMAL_ROUTES["kernel"] += 1
        return normal_kernel.calc_normal(scene, idx, p.detach())
    NORMAL_ROUTES["autograd_first_order"] += 1
    return calc_normal_autograd(scene, idx, p)


def calc_normal_autograd(scene: Scene, idx: torch.Tensor, p: torch.Tensor,
                         create_graph: bool = False) -> torch.Tensor:
    """The normal through autograd over every object's distance.
    ``create_graph``: the gradient at the attached ``p`` (a detached copy
    where ``p`` needs no grad) with its graph, so the normal is
    differentiable (second order through the SDF); else first order at a
    detached ``p``."""
    if create_graph:
        q = p if p.requires_grad else p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sd_object(scene, idx, q).sum(), q,
                                   create_graph=True)
    else:
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(sd_object(scene, idx, q).sum(), q)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def _safe_norm_grad(v, u):
    """The gradient of ``core/math.safe_norm`` over the components ``v``
    under the upstream ``u``, as autograd computes it: ``sqrt``'s
    ``u / (2 * result)`` behind both ``where`` guards (0 at ``v = 0``),
    and ``v * v``'s two equal terms ``gsq * v + gsq * v``."""
    sq = v[0] * v[0]
    for c in v[1:]:
        sq = sq + c * c
    pos = sq > 0
    safe = torch.sqrt(torch.where(pos, sq, 1.0))
    gsq = torch.where(pos, u / (2 * safe), 0.0)
    return [gsq * c + gsq * c for c in v]


def _max0_grad(x, g):
    """``torch.maximum(x, 0)``'s gradient to ``x`` under ``g``: ``g``
    above 0, half of it at the tie, 0 below (NaN passes ``g`` on)."""
    return torch.where(x < 0, 0.0, torch.where(x == 0, g / 2, g))


def _min_amax0_grad(q):
    """The gradient of ``torch.minimum(torch.amax(q), 0)`` over the
    components ``q`` under an upstream 1: ``minimum``'s 1, 0.5 at the tie
    or 0, split by ``amax`` evenly over the entries equal to the
    maximum."""
    inner = torch.amax(torch.stack(q, -1), dim=-1)
    gi = torch.where(inner > 0, 0.0, torch.where(inner == 0, 0.5, 1.0))
    ties = [(c == inner).to(inner.dtype) for c in q]
    cnt = ties[0]
    for t in ties[1:]:
        cnt = cnt + t
    return [(gi / cnt) * t for t in ties]


def _grad_box_like(d):
    """``min(amax(d), 0) + safe_norm(max(d, 0))``'s gradient to ``d``
    (``sd_round_box`` and ``sd_cylinder`` both end so)."""
    outside = _safe_norm_grad([torch.maximum(c, torch.zeros_like(c))
                               for c in d], torch.ones_like(d[0]))
    inside = _min_amax0_grad(d)
    return [_max0_grad(c, o) + i for c, o, i in zip(d, outside, inside)]


def _grad_box(x, y, z, s):
    p = (x, y, z)
    gq = _grad_box_like([torch.abs(c) - s[:, k] for k, c in enumerate(p)])
    return [g * torch.sign(c) for g, c in zip(gq, p)]


def _grad_cylinder(x, y, z, s):
    dxz = safe_norm(torch.stack([x, z], -1))
    gd = _grad_box_like([torch.abs(dxz) - s[:, 0], torch.abs(y) - s[:, 1]])
    gx, gz = _safe_norm_grad([x, z], gd[0] * torch.sign(dxz))
    return [gx, gd[1] * torch.sign(y), gz]


def _grad_cone(x, y, z, s):
    d = s[:, 0] * safe_norm(torch.stack([x, z], -1)) + s[:, 2] * y
    e = -s[:, 1] - y
    tie = torch.where(d == e, 0.5, 1.0)
    gd = torch.where(d < e, 0.0, tie)
    ge = torch.where(d > e, 0.0, tie)
    gx, gz = _safe_norm_grad([x, z], gd * s[:, 0])
    return [gx, gd * s[:, 2] + -ge, gz]


def _grad_mlp(p, mlp: BunnyMLP):
    """``sdf.bunny_mlp_eval``'s gradient at ``p`` (N, 3) under an upstream
    1, in autograd's backward formulas: ``mv``'s outer product gives
    ``w_out``; ``sin``'s ``g * cos z``; the division's ``g / 1.4`` (on the
    card a multiply by the float reciprocal, as the kernel's); the
    residual adds; each ``mm``'s ``g @ W.t()``. The contractions are
    matrix products, as autograd's are: the kernel's arithmetic wherever
    the product sums one fused multiply-add a term in k's order, as this
    CPU's does and cuBLAS's does at the frames' row counts
    (``csrc/normal.cu``)."""
    z0 = p @ mlp.w_in + mlp.b_in
    f0 = torch.sin(z0)
    z1 = f0 @ mlp.w_h1 + mlp.b_h1
    z2 = (torch.sin(z1) + f0) @ mlp.w_h2 + mlp.b_h2
    g_f = mlp.w_out.expand(z2.shape)
    g_f = g_f + (g_f / 1.4 * torch.cos(z2)) @ mlp.w_h2.t()
    g_f = g_f + (g_f * torch.cos(z1)) @ mlp.w_h1.t()
    return ((g_f * torch.cos(z0)) @ mlp.w_in.t()).unbind(-1)


def _grad_bunny(x, y, z, mlp: BunnyMLP):
    """``sdf.sd_bunny``'s gradient: ``safe_norm``'s outside the unit
    sphere, the MLP's inside (where autograd adds the other branch's exact
    zero, which the world frame's ``+ 0`` makes irrelevant)."""
    p = torch.stack([x, y, z], -1)
    outside = safe_norm(p) > 1.0
    g_out = _safe_norm_grad([x, y, z], torch.ones_like(x))
    g_in = _grad_mlp(p, mlp)
    return [torch.where(outside, a, b) for a, b in zip(g_out, g_in)]


def calc_normal_closed_plain(scene: Scene, idx: torch.Tensor,
                             p: torch.Tensor) -> torch.Tensor:
    """``calc_normal``'s first-order normal in closed form: the lane's own
    object alone, its SDF's gradient written out as autograd's backward
    computes it, operation for operation (``csrc/normal.cu`` runs the
    same arithmetic, a thread a lane). Bit-equal to ``calc_normal``, the
    bunny's sin-MLP included (:func:`_grad_bunny`).

    Autograd's order, where it decides the bits: ``abs`` passes
    ``g * sign(p)``; ``maximum``/``minimum`` give half the gradient to
    each side at a tie and ``amax`` splits it evenly over tied entries;
    ``safe_norm``'s square sums two equal terms; the rotation's transpose
    accumulates rows 2, 1, 0 into each world component, and every other
    object's gradient is +0, so an exact zero is +0; at a point not finite
    another curved object's (the bunny's too) is NaN. The normalisation is
    ``torch.linalg.vector_norm``'s (the kernel follows the card's
    reduction order)."""
    shape = p.shape
    i = idx.reshape(-1).to(torch.int64)
    pf = p.reshape(-1, 3)
    m = scene.matrix.index_select(0, i)
    pl = sdflib.to_object_space(pf, scene.position.index_select(0, i), m,
                                scene.local_offset.index_select(0, i))
    s = scene.scale.index_select(0, i)
    t = scene.type_ids.index_select(0, i)
    x, y, z = pl.unbind(-1)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    g = [zero, zero, zero]
    for shape_id, grads in (
            (SHAPE.SPHERE, lambda: _safe_norm_grad([x, y, z], one)),
            (SHAPE.BOX, lambda: _grad_box(x, y, z, s)),
            (SHAPE.CYLINDER, lambda: _grad_cylinder(x, y, z, s)),
            (SHAPE.CONE, lambda: _grad_cone(x, y, z, s)),
            (SHAPE.PLANE, lambda: [zero, one, zero]),
            (SHAPE.BUNNY, lambda: _grad_bunny(x, y, z, scene.bunny))):
        if shape_id in scene.shape_types:
            sel = t == int(shape_id)
            g = [torch.where(sel, a, b) for a, b in zip(grads(), g)]
    world = [((g[2] * m[:, 2, c] + g[1] * m[:, 1, c]) + g[0] * m[:, 0, c])
             + 0.0 for c in range(3)]
    n = torch.stack(world, -1)
    curved = (((t >= int(SHAPE.SPHERE)) & (t <= int(SHAPE.CONE)))
              | (t == int(SHAPE.BUNNY))).to(t.dtype)
    lost = ~torch.isfinite(pf).all(-1) & (
        normal_kernel.num_curved(scene) > curved)
    n = torch.where(lost[:, None], torch.nan, n)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n.reshape(shape)


def calc_normal_tetrahedron(scene: Scene, idx: torch.Tensor,
                            p: torch.Tensor,
                            h: float = 0.5773 * 0.005) -> torch.Tensor:
    """Parity normal: the reference's 4-tap tetrahedron estimate of the
    selected object's SDF (``sdf.tetrahedron_normal``)."""
    return sdflib.tetrahedron_normal(lambda q: sd_object(scene, idx, q), p,
                                     h)


def animate(scene: Scene, frame, spin_axis=(0.0, 0.0, 1.0),
            period: float = 120.0, bob: float = 0.1) -> Scene:
    """Animation of the bunny scenes: after the object rotation, spin about
    z by ``t = pi*frame/period`` and bob along z by ``bob*sin(t)``, folded
    into the baked matrix and the post-rotation ``local_offset``. ``frame``
    may be a tensor on the scene's device (no host sync)."""
    dt = scene.position.dtype
    frame = torch.as_tensor(frame, device=scene.device)
    t = math.pi * frame.to(dt) / period
    axis = torch.tensor(spin_axis, dtype=dt, device=scene.device)
    r_anim = rotate_euler(axis * t)
    new_matrix = torch.einsum("ij,njk->nik", r_anim, scene.matrix)
    offset = torch.broadcast_to(
        torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=scene.device)
        * bob * torch.sin(t), scene.local_offset.shape)
    return scene.replace(matrix=new_matrix, local_offset=offset,
                         rot_perm=(None,) * scene.num_objects)
