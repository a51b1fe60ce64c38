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

from ..core.device import resolve
from ..core.math import rotate_euler
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


def materials_at(scene: Scene, idx: torch.Tensor) -> Materials:
    """All six material parameters of object ``idx`` per lane: one gather
    from the packed (n_obj, 10) table (the TPU's one-hot matmul is a GPU
    gather). ``index_select``, not advanced indexing: the same values, and
    its backward is an ``index_add_`` (atomic adds on the card), where the
    advanced index's sorts the lanes and sums each object's hundreds of
    thousands of duplicates in one warp (on the H100 over 90% of a
    gradient step, PERF.md)."""
    table = torch.cat([scene.albedo, scene.emission,
                       scene.roughness[:, None], scene.metallic[:, None],
                       scene.transmission[:, None], scene.ior[:, None]], -1)
    m = table.index_select(0, idx.reshape(-1).to(torch.int64)).reshape(
        idx.shape + (10,))
    return Materials(m[..., 0:3], m[..., 3:6], m[..., 6], m[..., 7],
                     m[..., 8], m[..., 9])


def calc_normal(scene: Scene, idx: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """Analytic surface normal: normalized gradient of ``sd_object`` with
    respect to ``p``, through autograd.

    Where autograd records (grad mode on, and ``p`` or a buffer the SDF
    reads requires grad) the gradient is taken with ``create_graph=True``
    at the attached ``p``, so the normal is differentiable in ``p`` and in
    the geometry, as ``jax.grad``'s normal is (second order through the
    SDF). Otherwise ``p`` is detached and the gradient is first order: the
    forward render's numbers."""
    sdf_reads = (scene.position, scene.scale, scene.matrix,
                 scene.local_offset) + tuple(scene.bunny or ())
    if torch.is_grad_enabled() and (
            p.requires_grad or any(t.requires_grad for t in sdf_reads)):
        q = p if p.requires_grad else p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sd_object(scene, idx, q).sum(), q,
                                   create_graph=True)
    else:
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(sd_object(scene, idx, q).sum(), q)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


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
