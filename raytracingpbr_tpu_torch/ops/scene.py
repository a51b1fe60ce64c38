"""Scene representation and geometry queries (port of
``raytracingpbr_tpu/ops/scene.py``).

``Scene`` is an ``nn.Module`` whose per-object tensors are buffers, so
``scene.to(device)`` moves it; its static metadata (``shape_types``,
``type_splits``, ``bucket_types``, ``box_round``, ``rot_perm``) are plain
attributes. Objects are sorted by shape type and evaluated bucket by bucket,
as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import sdf as sdflib
from .sdf import SHAPE

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


class Scene(nn.Module):
    """Struct-of-arrays scene: (n, ...) buffers over objects plus static
    metadata. ``rot_perm[i]`` is None or ``((p0, p1, p2), (s0, s1, s2))``:
    row r of object i's matrix is ``s_r * e_{p_r}`` (a signed
    permutation)."""

    def __init__(self, shape_types, type_splits, bucket_types, box_round,
                 rot_perm, **tensors):
        super().__init__()
        if SHAPE.BUNNY in shape_types:
            raise NotImplementedError(
                "the neural-bunny SDF is not ported yet")
        self.shape_types = tuple(int(t) for t in shape_types)
        self.type_splits = tuple(int(s) for s in type_splits)
        self.bucket_types = tuple(int(t) for t in bucket_types)
        self.box_round = float(box_round)
        self.rot_perm = tuple(rot_perm)
        for name in _BUFFERS:
            self.register_buffer(name, tensors[name])
        # the shape types as a device array, for the CUDA march kernel
        self.register_buffer("type_ids", torch.tensor(
            self.shape_types, dtype=torch.int32,
            device=tensors["position"].device))

    @property
    def num_objects(self) -> int:
        return len(self.shape_types)

    @property
    def device(self) -> torch.device:
        return self.position.device


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
    objs = sorted(objects, key=lambda o: int(o.shape))
    types = tuple(int(o.shape) for o in objs)
    splits, bucket_types = bucket_layout(types)

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
    )


def _sd_typed(scene: Scene, type_id: int, p_local, scale):
    if type_id == SHAPE.BOX:
        return sdflib.sd_round_box(p_local, scale, scene.box_round)
    return sdflib.SHAPE_FUNC[SHAPE(type_id)](p_local, scale)


def all_distances(scene: Scene, p: torch.Tensor) -> torch.Tensor:
    """Signed distance from points ``p`` (..., 3) to every object ->
    (..., n), one static bucket of equal-typed objects at a time."""
    chunks = []
    for b, t in enumerate(scene.bucket_types):
        lo, hi = scene.type_splits[b], scene.type_splits[b + 1]
        pl = sdflib.to_object_space(p[..., None, :], scene.position[lo:hi],
                                    scene.matrix[lo:hi],
                                    scene.local_offset[lo:hi])
        chunks.append(_sd_typed(scene, t, pl, scene.scale[lo:hi]))
    return torch.cat(chunks, dim=-1)


def nearest(scene: Scene, p: torch.Tensor):
    """Nearest object index (int32) and min |sd|, as a running minimum that
    starts at MAX_DIS with a strict ``<``.

    This is the march kernel's convention: the first object wins ties, the
    distance is clamped at MAX_DIS, and the index stays 0 on points where
    no distance is below MAX_DIS. (JAX's ``nearest`` takes an argmin and
    then clamps, so on such far points its index can differ; it agrees
    everywhere else.)"""
    d = torch.abs(all_distances(scene, p))
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
        else:  # SHAPE.NONE
            r = torch.zeros_like(s0)
        radii.append(r)
    r_obj = (torch.linalg.vector_norm(scene.position, dim=-1)
             + torch.linalg.vector_norm(scene.local_offset, dim=-1)
             + torch.stack(radii))
    return torch.amax(r_obj) * 1.05 + 0.1


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
    gather)."""
    table = torch.cat([scene.albedo, scene.emission,
                       scene.roughness[:, None], scene.metallic[:, None],
                       scene.transmission[:, None], scene.ior[:, None]], -1)
    m = table[idx.to(torch.int64)]
    return Materials(m[..., 0:3], m[..., 3:6], m[..., 6], m[..., 7],
                     m[..., 8], m[..., 9])


def calc_normal(scene: Scene, idx: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """Analytic surface normal: normalized gradient of ``sd_object`` with
    respect to ``p``, through autograd."""
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sd_object(scene, idx, q).sum(), q)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
