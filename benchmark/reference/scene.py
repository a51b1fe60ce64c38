"""The reference's scene: objects from the benchmark's data, their signed
distances, the nearest-object query, the autograd normal and the material
table (a frozen copy of the program's plain ``ops/scene.py`` and
``ops/sdf.py`` arithmetic). Each shape's signed distance is a part,
``shapes/<shape>.py``."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import part

MAX_DIS = 1e3
# the bunny MLP's tensors, 3 -> 16 -> 16 -> 16 -> 1, in the weights file
BUNNY_FIELDS = ("w_in", "b_in", "w_h1", "b_h1", "w_h2", "b_h2", "w_out",
                "bias_out")
MATERIAL = ("albedo", "emission", "roughness", "metallic", "transmission",
            "ior")
SDF_BUFFERS = ("position", "scale", "matrix", "local_offset")


@dataclasses.dataclass
class Scene:
    """Objects sorted by shape id, as (n, ...) tensors, and the bunny's
    weights (a tuple in :data:`BUNNY_FIELDS` order) when it has one;
    ``bucket_shapes`` names each bucket's shape part."""

    types: Tuple[int, ...]
    splits: Tuple[int, ...]
    bucket_types: Tuple[int, ...]
    box_round: float
    position: torch.Tensor
    rotation: torch.Tensor
    scale: torch.Tensor
    matrix: torch.Tensor
    local_offset: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    transmission: torch.Tensor
    ior: torch.Tensor
    bunny: Optional[tuple] = None
    bucket_shapes: Tuple[str, ...] = ()

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    @property
    def num_objects(self) -> int:
        return len(self.types)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def leaves(self) -> dict:
        """Every float tensor by name: the objects' and ``bunny_<field>``."""
        out = {k: getattr(self, k) for k in SDF_BUFFERS + MATERIAL}
        out["rotation"] = self.rotation
        if self.bunny is not None:
            out.update({"bunny_" + k: v
                        for k, v in zip(BUNNY_FIELDS, self.bunny)})
        return out

    def with_leaves(self, tensors: dict) -> "Scene":
        """A scene with the named tensors (as :meth:`leaves` names them)
        replaced."""
        kw = {k: v for k, v in tensors.items() if not k.startswith("bunny_")}
        if any(k.startswith("bunny_") for k in tensors):
            mlp = dict(zip(BUNNY_FIELDS, self.bunny))
            mlp.update({k[6:]: v for k, v in tensors.items()
                        if k.startswith("bunny_")})
            kw["bunny"] = tuple(mlp[k] for k in BUNNY_FIELDS)
        return self.replace(**kw)

    def to(self, dtype: torch.dtype) -> "Scene":
        """The same scene with every float tensor in ``dtype``."""
        return self.with_leaves({k: v.to(dtype)
                                 for k, v in self.leaves().items()})


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    acc = v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _sum_last(a * b)


def safe_norm(v: torch.Tensor) -> torch.Tensor:
    sq = _sum_last(v * v)
    pos = sq > 0
    safe = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return torch.where(pos, safe, torch.zeros_like(sq))


def rotate_euler(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles (radians, (..., 3)) -> (..., 3, 3), Rz @ Ry @ Rx."""
    s = torch.sin(angles)
    c = torch.cos(angles)
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rz = mat([[cz, sz, zero], [-sz, cz, zero], [zero, zero, one]])
    ry = mat([[cy, zero, -sy], [zero, one, zero], [sy, zero, cy]])
    rx = mat([[one, zero, zero], [zero, cx, sx], [zero, -sx, cx]])
    return rz @ ry @ rx


def _snap(mats: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """Entries within ``tol`` of -1, 0 or 1 set to it exactly."""
    mats = mats.copy()
    near = np.abs(mats - np.round(mats)) < tol
    mats[near] = np.round(mats[near])
    return mats


def load_mlp(path: str, device) -> tuple:
    """The bunny's weights from an ``.npz`` with :data:`BUNNY_FIELDS`."""
    with np.load(path) as z:
        return tuple(torch.tensor(z[k], dtype=torch.float32, device=device)
                     for k in BUNNY_FIELDS)


def build_scene(objects: Sequence[dict], box_round: float, device,
                mlp: Optional[tuple] = None) -> Scene:
    """The scene of the benchmark's object list (each a dict with
    ``shape`` and the transform and material fields): sorted by shape id
    (stably), the rotation matrices baked on the host in float32 and
    snapped."""
    objs = sorted(objects, key=lambda o: part("shapes", o["shape"]).ID)
    types = tuple(part("shapes", o["shape"]).ID for o in objs)
    splits, buckets, names = [0], [], []
    for i, (t, o) in enumerate(zip(types, objs)):
        if not buckets or t != buckets[-1]:
            if buckets:
                splits.append(i)
            buckets.append(t)
            names.append(o["shape"])
    splits.append(len(types))
    weights = any(part("shapes", n).WEIGHTS for n in names)
    if weights and mlp is None:
        raise ValueError("a scene with the bunny needs its weights")

    def stack(key, tail=(3,)):
        arr = np.array([o[key] for o in objs], dtype=np.float32)
        return torch.as_tensor(arr.reshape((len(objs),) + tail),
                               dtype=torch.float32, device=device)

    rotation = stack("rotation")
    rad = rotation.cpu() * (math.pi / 180.0)
    mats = _snap(rotate_euler(rad).numpy())
    return Scene(
        types, tuple(splits), tuple(buckets), float(box_round),
        position=stack("position"), rotation=rotation, scale=stack("scale"),
        matrix=torch.as_tensor(mats, dtype=torch.float32, device=device),
        local_offset=torch.zeros((len(objs), 3), dtype=torch.float32,
                                 device=device),
        albedo=stack("albedo"), emission=stack("emission"),
        roughness=stack("roughness", ()), metallic=stack("metallic", ()),
        transmission=stack("transmission", ()), ior=stack("ior", ()),
        bunny=mlp if weights else None, bucket_shapes=tuple(names))


# --- signed distances --------------------------------------------------------


def to_object_space(p, position, matrix, offset):
    q = p - position
    rows = []
    for r in range(3):
        v = (matrix[..., r, 0] * q[..., 0] + matrix[..., r, 1] * q[..., 1]
             + matrix[..., r, 2] * q[..., 2])
        rows.append(v + offset[..., r])
    return torch.stack(rows, -1)


def all_distances(scene: Scene, p: torch.Tensor, chains: bool = False):
    """Signed distance of points ``p`` (..., 3) to every object, (..., n),
    one bucket of objects of one shape at a time. ``chains``: the bunny
    in the march kernels' order; else with matrix products."""
    out = []
    for b, name in enumerate(scene.bucket_shapes):
        lo, hi = scene.splits[b], scene.splits[b + 1]
        pl = to_object_space(p[..., None, :], scene.position[lo:hi],
                             scene.matrix[lo:hi], scene.local_offset[lo:hi])
        out.append(part("shapes", name).sd(scene, lo, hi, pl, chains))
    return torch.cat(out, dim=-1)


def nearest(scene: Scene, p: torch.Tensor, chains: bool = True):
    """Nearest object (int32) and min |sd|: a running minimum from
    :data:`MAX_DIS` with a strict ``<``, the first object winning ties."""
    d = torch.abs(all_distances(scene, p, chains))
    best = torch.full(d.shape[:-1], MAX_DIS, dtype=d.dtype, device=d.device)
    idx = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)
    for i in range(scene.num_objects):
        take = d[..., i] < best
        idx = torch.where(take, i, idx)
        best = torch.where(take, d[..., i], best)
    return idx, best


def sd_object(scene: Scene, idx: torch.Tensor, p: torch.Tensor):
    d = all_distances(scene, p)
    return torch.gather(d, -1, idx.to(torch.int64)[..., None])[..., 0]


def sdf_reads(scene: Scene) -> tuple:
    return (tuple(getattr(scene, k) for k in SDF_BUFFERS)
            + tuple(scene.bunny or ()))


def with_sdf_reads(scene: Scene, tensors) -> Scene:
    kw = dict(zip(SDF_BUFFERS, tensors[:len(SDF_BUFFERS)]))
    if scene.bunny is not None:
        kw["bunny"] = tuple(tensors[len(SDF_BUFFERS):])
    return scene.replace(**kw)


def calc_normal(scene: Scene, idx: torch.Tensor, p: torch.Tensor):
    """Normalised gradient of :func:`sd_object` in ``p``; differentiable
    (second order) where autograd records."""
    if torch.is_grad_enabled() and (
            p.requires_grad or any(t.requires_grad
                                   for t in sdf_reads(scene))):
        q = p if p.requires_grad else p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sd_object(scene, idx, q).sum(), q,
                                   create_graph=True)
    else:
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(sd_object(scene, idx, q).sum(), q)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def materials_at(scene: Scene, idx: torch.Tensor):
    """(albedo, emission, roughness, metallic, transmission, ior) per lane,
    one gather from the (n, 10) table."""
    table = torch.cat([scene.albedo, scene.emission,
                       scene.roughness[:, None], scene.metallic[:, None],
                       scene.transmission[:, None], scene.ior[:, None]], -1)
    m = table.index_select(0, idx.reshape(-1).to(torch.int64)).reshape(
        idx.shape + (10,))
    return (m[..., 0:3], m[..., 3:6], m[..., 6], m[..., 7], m[..., 8],
            m[..., 9])
