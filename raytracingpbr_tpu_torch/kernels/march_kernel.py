"""Hand-written CUDA march kernels K1a, K1b, K1c (``csrc/march.cu``) and
K1d (``csrc/march_mxu.cu``), and their wrapper.

They replace the Pallas TPU kernel
``raytracingpbr_tpu/pallas/march_kernel.py::_march_kernel``; each variant
is named here by what it adds:

- ``k1a``: CONSTANT omega, ABSOLUTE hit test, no escape bound, analytic
  shapes (the Cornell wavefront's march);
- ``k1b``: the ROLLBACK_TO_ONE / ROLLBACK_HALF_UP policies, the CONE /
  RELATIVE hit tests and the escape bound, on analytic shapes;
- ``k1c``: any of those on a scene with the neural bunny (the MLP of
  ``_bunny_tile`` as FP32 chains, weights packed by :func:`pack_bunny`);
- ``k1d``: the same with ``cfg.bunny_mxu``: the MLP's 16 x 16 layers on
  the tensor cores (``_bunny_tile_mxu``; weights packed by
  :func:`pack_bunny_mxu`).

All have the active gate and the resume from ``(t, w, s, d)``.

What bounds them on an H100: FP32 issue (about 25 flops per analytic
object per lane-trip; about 1,250 flops and 48 sinf for a bunny lane inside
the unit sphere), while a lane reads about 41 bytes and writes 29 once
(``utils/speedlight.march_bound``). K1a and K1b run one thread per lane
with a per-lane loop exit and spend their issue slots on the object loop
(``csrc/march.cu`` gives the measured counts). The TPU kernel unrolls that
loop over static shape types and skips the matrix of a signed permutation
(``_nearest_tile``, ``march_kernel.py:229-271``). Here :func:`pack_groups`
orders the objects into groups of one (shape, permutation or matrix)
kind, a permutation group in runs by the world axis its SDF reads last or
alone; each run is a loop with its SDF and transform compiled in (no type
switch on an object), a permutation folded per world axis so that it
takes no matrix products, its record read as 16-byte vectors at addresses
uniform over the warp from shared memory. The running min is
lexicographic over (distance, index), so the result is the plain
version's, bit for bit, whatever order the groups come in. K1c and K1d
share a persistent lane pool (``csrc/march_pool.cuh``):
as many blocks as fit on the card, each of :data:`POOL_SLOTS` slots that
take the next lane from a counter when their lane is done and march on
their own until their point lies inside a bunny's unit sphere; then a
compacted queue of those points, on which alone the MLP runs, spread over
the block (K1c: FP32 chains, an entry a thread; K1d: ``mma.sync``, 32
entries a warp).

The wrapper packs a scene for the kernels (:func:`scene_packs`) once per
``Scene`` object and keeps the packs on it: a frame's calls share them, and
no call copies anything to the host.

The plain PyTorch version is ``ops/march.march_resumable_plain``;
``ops/march.march_resumable`` sends CPU tensors there and CUDA tensors here.
This wrapper never falls back: a CUDA tensor is marched by a kernel, or the
call raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from ..ops import scene as scenelib
from ..ops.sdf import SHAPE
from . import build

BLOCK = 256
# lanes a block of K1c or K1d holds at once (csrc/march_pool.cuh)
POOL_SLOTS = 256
# threads a block of K1a and K1b, a lane each
ANALYTIC_BLOCK = 256

# Kernel launches made by march_resumable_cuda, per variant: plain
# counters that a run resets and reads to show which path it went through.
LAUNCHES = {"k1a": 0, "k1b": 0, "k1c": 0, "k1d": 0}
# Of those, the launches of the escape-bound instance: on a render path,
# NEE's shadow rays (no model config sets ``cfg.escape_bound``).
BOUND_LAUNCHES = {"k1a": 0, "k1b": 0, "k1c": 0, "k1d": 0}

_POLICY = {OmegaPolicy.CONSTANT: 0, OmegaPolicy.ROLLBACK_TO_ONE: 1,
           OmegaPolicy.ROLLBACK_HALF_UP: 2}
_CRIT = {HitCriterion.ABSOLUTE: 0, HitCriterion.RELATIVE: 1,
         HitCriterion.CONE: 2}
# the library of each variant (csrc/<source>.cu)
_SOURCE = {"k1a": "march", "k1b": "march", "k1c": "march",
           "k1d": "march_mxu"}

_libs = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        BOUND_LAUNCHES[k] = 0


def declare(lib: ctypes.CDLL, source: str = "march") -> ctypes.CDLL:
    """Declares the C ABI of a library built from ``csrc/<source>.cu``
    (both march sources export ``rt_march``, ``rt_march_max_objects`` and
    ``rt_pool_occupancy``; ``march_mxu`` also ``rt_bunny_mlp_mxu``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_march.argtypes = ([p, p, p, i, f, p, p, p, p, p, p, p, f, f,
                              f, f, f, f, i, i, i, i, i] + [p] * 10
                             + [i, p])
    lib.rt_march.restype = i
    lib.rt_march_max_objects.argtypes = []
    lib.rt_march_max_objects.restype = i
    lib.rt_pool_occupancy.argtypes = [p, p]
    lib.rt_pool_occupancy.restype = i
    if source == "march_mxu":
        lib.rt_bunny_mlp_mxu.argtypes = [p, p, p, i, i, p]
        lib.rt_bunny_mlp_mxu.restype = i
    return lib


def load(source: str = "march"):
    """Build if needed, then load ``csrc/<source>.cu`` and declare its C
    ABI (:func:`declare`)."""
    if source not in _libs:
        _libs[source] = declare(build.load(source), source)
    return _libs[source]


def pack_scene(scene, bound2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-object transform block (n, 32) f32: [pos(3), scale(3), matrix
    row-major (9), local_offset(3), bound^2 (1), pad(13)] — the TPU
    kernel's layout. Column 18 holds ``bound2``, the squared scene bound
    of the escape test (``scene.escape_bound2``, the value the plain march
    compares against), or 0 without one."""
    n = scene.num_objects
    dev, dt = scene.position.device, scene.position.dtype
    b2 = (torch.zeros((n, 1), dtype=dt, device=dev) if bound2 is None
          else bound2.reshape(1, 1).expand(n, 1))
    return torch.cat([scene.position, scene.scale, scene.matrix.reshape(n, 9),
                      scene.local_offset, b2,
                      torch.zeros((n, 13), dtype=dt, device=dev)], -1)


def pack_bunny(scene) -> torch.Tensor:
    """The bunny MLP as a (40, 16) f32 block: rows 0-2 w_in, 3 b_in, 4-19
    w_h1, 20 b_h1, 21-36 w_h2, 37 b_h2, 38 w_out, 39 [bias_out, 0...]."""
    b = scene.bunny
    last = torch.zeros((1, 16), dtype=b.w_in.dtype, device=b.w_in.device)
    last[0, 0] = b.bias_out
    return torch.cat([b.w_in, b.b_in[None], b.w_h1, b.b_h1[None], b.w_h2,
                      b.b_h2[None], b.w_out[None], last], 0)


def _mxu_layout():
    """Source index into the flat weight vector of :func:`pack_bunny_mxu`
    (w_in, b_in, w_h1, b_h1, w_h2, b_h2, w_out row-major, then bias_out and
    a zero) for each (row, lane) of the pack, and each row's kind: 0 the
    f32 value, 1 its TF32 rounding (big), 2 the TF32 rounding of the rest
    (small)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    src = np.full((64, 32), 625, np.int64)
    kind = np.zeros((64, 1), np.int64)
    for q in range(4):  # feature slot q of lane (g, t): 8 nt + 2 t + j
        f = 8 * (q >> 1) + 2 * t + (q & 1)
        for c in range(3):
            src[4 * q + c] = 16 * c + f          # w_in[c][f]
        src[4 * q + 3] = 48 + f                  # b_in[f]
        src[56 + q] = 608 + f                    # w_out[f]
    for h, (w0, b0) in enumerate(((64, 320), (336, 592))):
        base = 16 + 20 * h
        for q in range(4):
            src[base + 16 + q] = b0 + 8 * (q >> 1) + 2 * t + (q & 1)
        for m in range(4):  # m = 2 kk + nt
            kk, nt = divmod(m, 2)
            k0, n = 8 * kk + 2 * t, 8 * nt + g
            r = base + 4 * m
            src[r] = src[r + 2] = w0 + 16 * k0 + n        # W[k0][n]
            src[r + 1] = src[r + 3] = w0 + 16 * (k0 + 1) + n
            kind[r:r + 2] = 1
            kind[r + 2:r + 4] = 2
    src[60] = 624
    return src, kind


_MXU_SRC, _MXU_KIND = _mxu_layout()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` does."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def pack_bunny_mxu(scene) -> torch.Tensor:
    """The bunny MLP in the layout of K1d's ``mma.sync`` fragments: a (64,
    32) f32 block, one float per lane in each row. For lane ``4 g + t``,
    feature slot ``q = 2 nt + j`` is feature ``8 nt + 2 t + j``:

    - rows 0-15: ``4 q + c``, w_in[c][f] for c < 3, b_in[f] for c = 3;
    - rows 16-35 (w_h1) and 36-55 (w_h2): for ``m = 2 kk + nt``, rows
      ``4 m + (0, 1)`` hold the TF32 roundings of W[8 kk + 2 t][8 nt + g]
      and W[8 kk + 2 t + 1][8 nt + g] (the B fragment with the K index
      permuted to match the accumulator layout), ``4 m + (2, 3)`` the TF32
      roundings of what those leave; then 4 rows of the layer's bias[f];
    - rows 56-59: w_out[f]; row 60: bias_out; rows 61-63: zero.

    The TPU's kron(Wᵀ, I₈) layout served its (8, 128) tiles and is not
    copied."""
    b = scene.bunny
    dev, dt = b.w_in.device, b.w_in.dtype
    flat = torch.cat([b.w_in.reshape(-1), b.b_in, b.w_h1.reshape(-1),
                      b.b_h1, b.w_h2.reshape(-1), b.b_h2, b.w_out,
                      b.bias_out.reshape(1), torch.zeros(1, dtype=dt,
                                                         device=dev)])
    v = flat[torch.as_tensor(_MXU_SRC, device=dev)]
    big = _tf32(v)
    small = _tf32(v - big)
    kind = torch.as_tensor(_MXU_KIND, device=dev)
    return torch.where(kind == 1, big, torch.where(kind == 2, small, v))


# the variants whose kernel reads a pack of the bunny's weights: the pool
_POOLED = ("k1c", "k1d")

# K1a/K1b's object groups (csrc/march.cu): a kind is (shape, transform),
# 2 * shape + (0 a signed permutation, 1 the matrix) over _GROUP_SHAPES. A
# permutation is further keyed by a world axis (run 0, 1 or 2 of its
# group); XF_MATRIX is the matrix's transform. NONE objects are in no
# group: at MAX_DIS they never win the running min.
_GROUP_SHAPES = (SHAPE.SPHERE, SHAPE.BOX, SHAPE.CYLINDER, SHAPE.CONE,
                 SHAPE.PLANE)
XF_MATRIX = 3
MAX_GROUPS = len(_GROUP_SHAPES) * 2
RECORD = 24  # floats a record of pack_groups


def group_kind(shape: int, perm) -> Optional[int]:
    """The group kind of an object of ``shape`` with ``rot_perm`` entry
    ``perm``, or None for NONE."""
    if shape == SHAPE.NONE:
        return None
    return 2 * _GROUP_SHAPES.index(shape) + int(perm is None)


def transform(shape: int, perm) -> int:
    """XF_MATRIX, or the world axis a permutation is keyed by: the axis the
    SDF reads last or alone, row 2's for the sphere and the box (the last
    term of their sums of squares), row 1's for the cylinder, the cone and
    the plane."""
    if perm is None:
        return XF_MATRIX
    return perm[0][2] if shape in (SHAPE.SPHERE, SHAPE.BOX) else perm[0][1]


@functools.lru_cache(maxsize=256)
def group_layout(shape_types: tuple, rot_perm: tuple):
    """The static part of :func:`pack_groups`: ``(groups, order, src,
    neg)``. ``groups``: (kind, e0, e1, e2) in kind order, a group's records
    running from the previous e2 (0 first) to its e2, a permutation group's
    keyed by axis 0 up to e0, 1 up to e1 and 2 up to e2 (a matrix group's
    e0 = e1 = its first record); ``order``: the object of each record, by
    kind, key axis and index; ``src`` (n, RECORD) int64: where each float
    of a record comes from in :func:`_pack_values`; ``neg`` (n, RECORD)
    bool: whether it is negated (a permutation's sign)."""
    n = len(shape_types)
    pos, scale, mat, off = 0, 3 * n, 6 * n, 15 * n
    zero, one, index = 18 * n, 18 * n + 1, 18 * n + 2
    keys = sorted((group_kind(t, p), transform(t, p) % XF_MATRIX, i)
                  for i, (t, p) in enumerate(zip(shape_types, rot_perm))
                  if t != SHAPE.NONE)
    order = [i for _, _, i in keys]
    groups = []
    for kind in sorted({k for k, _, _ in keys}):
        start = groups[-1][3] if groups else 0
        ends = [start + sum(1 for k, a, _ in keys if k == kind and a <= axis)
                for axis in range(3)]
        if kind % 2:  # a matrix group: one run
            ends[0] = ends[1] = start
        groups.append((kind, *ends))
    src = np.full((n, RECORD), zero, np.int64)
    neg = np.zeros((n, RECORD), bool)
    for j, i in enumerate(order):
        r, g = src[j], neg[j]
        r[0:3] = pos + 3 * i + np.arange(3)
        r[3] = index + i
        r[7:10] = scale + 3 * i + np.arange(3)  # a0, a1, a2
        for row in range(3):  # permutations too: non-finite points read it
            r[12 + 4 * row:15 + 4 * row] = mat + 9 * i + 3 * row + \
                np.arange(3)
        perm = rot_perm[i]
        if perm is None:
            r[4:7] = off + 3 * i + np.arange(3)
            continue
        cols, signs = perm
        row_of = [cols.index(a) for a in range(3)]  # the row reading axis a
        for a in range(3):
            r[4 + a] = off + 3 * i + row_of[a]
            g[4 + a] = signs[row_of[a]] < 0
        if shape_types[i] == SHAPE.BOX:
            r[7:10] = scale + 3 * i + np.array(row_of)
        elif shape_types[i] == SHAPE.PLANE:
            g[8] = signs[1] < 0
        elif shape_types[i] == SHAPE.CONE:
            r[10], g[10] = one, signs[1] < 0
    return tuple(groups), tuple(order), src, neg


def _pack_values(scene) -> torch.Tensor:
    """What :func:`group_layout`'s ``src`` indexes: the scene's position,
    scale, matrix and local offset flattened, then 0, 1 and the object
    indices 0 .. n-1 as floats."""
    n = scene.num_objects
    dev, dt = scene.position.device, scene.position.dtype
    return torch.cat([scene.position.reshape(-1), scene.scale.reshape(-1),
                      scene.matrix.reshape(-1), scene.local_offset.reshape(-1),
                      torch.zeros(1, dtype=dt, device=dev),
                      torch.ones(1, dtype=dt, device=dev),
                      torch.arange(n, dtype=dt, device=dev)])


def _static(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without waiting on the stream: through
    pinned memory and an asynchronous copy for the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def pack_groups(scene, bound2: Optional[torch.Tensor] = None):
    """K1a/K1b's packs of ``scene``: ``(params, table)``.

    ``params`` (4 + n * RECORD,) f32: a header [bound2 or 0, 0, 0, 0], then
    a record an object in group order (NONE objects none; unused records
    zero): position, index, offset, a0, a1, a2, a3, 0, the matrix rows each
    padded to 4 (a permutation's too: the kernels read it on points with a
    NaN or an infinite coordinate). A matrix object keeps its offset and
    scale (a0-a2). A
    signed permutation in ``scene.rot_perm`` (row r reads world axis c_r
    with sign s_r) gets, per world axis a, the offset of the row reading it
    times that row's sign; the box its scales by axis; the cone a3 = s_1;
    the plane a1 = s_1 * sy (``csrc/march.cu`` says why each is exact).
    ``table`` (1 + MAX_GROUPS, 4) i32: [groups, 0, 0, 0], then a group's
    (kind, e0, e1, e2) of :func:`group_layout`. ``rot_perm`` must describe
    ``scene.matrix``, as ``make_scene`` sets it (``bake`` and ``animate``
    clear it)."""
    groups, _, src, neg = group_layout(scene.shape_types, scene.rot_perm)
    dev, dt = scene.position.device, scene.position.dtype
    v = _pack_values(scene)[_static(src, dev)]
    rec = torch.where(_static(neg, dev), -v, v)
    head = torch.zeros(4, dtype=dt, device=dev)
    if bound2 is not None:
        head = torch.cat([bound2.reshape(1).to(dt), head[1:]])
    table = np.zeros((1 + MAX_GROUPS, 4), np.int32)
    table[0, 0] = len(groups)
    table[1:1 + len(groups)] = np.array(groups, np.int32).reshape(-1, 4)
    return torch.cat([head, rec.reshape(-1)]), _static(table, dev)


def _pack_sources(scene):
    return ((scene.position, scene.scale, scene.matrix, scene.local_offset)
            + (tuple(scene.bunny) if scene.has_bunny else ()))


def scene_packs(scene, kind: str, cfg: RenderConfig):
    """``(bound2, params, extra)`` for variant ``kind``'s kernel:
    ``scene.escape_bound2`` (None without the test); for K1c and K1d
    :func:`pack_scene` with it and the bunny's pack (:func:`pack_bunny`,
    :func:`pack_bunny_mxu`); for K1a and K1b the two packs of
    :func:`pack_groups`. Each is contiguous.

    Computed once per scene object and kept on it, so the calls of a frame
    share them and the packs die with the scene. ``make_scene``, ``bake``
    and ``animate`` return new scenes; a buffer the scene replaces
    (``scene.to``) is seen by identity, and one changed in place (``add_``,
    ``copy_``, an optimizer step) by its version counter: either packs
    anew."""
    pooled = kind in _POOLED
    key = (kind if pooled else scene.rot_perm,
           scenelib.has_escape_bound(scene, cfg))
    sources = _pack_sources(scene)
    versions = tuple(getattr(v, "_version", None) for v in sources)
    cache = scene.__dict__.setdefault("_march_packs", {})
    hit = cache.get(key)
    if (hit is not None and hit[1] == versions
            and all(a is b for a, b in zip(hit[0], sources))):
        return hit[2]
    bound2 = scenelib.escape_bound2(scene, cfg)
    if pooled:
        params = pack_scene(scene, bound2).contiguous()
        pack = pack_bunny if kind == "k1c" else pack_bunny_mxu
        extra = pack(scene).contiguous()
    else:
        params, extra = pack_groups(scene, bound2)
    cache[key] = (sources, versions, (bound2, params, extra))
    return bound2, params, extra


def pool_occupancy(kind: str):
    """``(blocks per SM, SMs)`` of the persistent grid of K1c or K1d on the
    current card (of the CONSTANT + RELATIVE instance the bunny paths run,
    on a one-object scene): the grid is their product, capped at a block
    per :data:`POOL_SLOTS` lanes."""
    lib = load(_SOURCE[kind])
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.rt_pool_occupancy(ctypes.byref(per_sm), ctypes.byref(sms))
    if rc != 0:
        raise RuntimeError(f"occupancy query of {kind} failed: CUDA error "
                           f"{rc}")
    return per_sm.value, sms.value


def variant(scene, cfg: RenderConfig) -> str:
    """The kernel that marches this scene under this config: ``k1a``,
    ``k1b``, ``k1c`` or ``k1d``. Raises NotImplementedError for what none
    serves."""
    if cfg.omega_policy not in _POLICY or cfg.hit_criterion not in _CRIT:
        raise NotImplementedError(
            f"no CUDA march serves {cfg.omega_policy} with "
            f"{cfg.hit_criterion}")
    if SHAPE.BUNNY in scene.shape_types:
        return "k1d" if cfg.bunny_mxu else "k1c"
    if (cfg.omega_policy == OmegaPolicy.CONSTANT
            and cfg.hit_criterion == HitCriterion.ABSOLUTE
            and not scenelib.has_escape_bound(scene, cfg)):
        return "k1a"
    return "k1b"


def _vec(x: torch.Tensor, n: int, dtype, name: str) -> torch.Tensor:
    if x.shape != (n,) or x.dtype != dtype or not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA ({n},) {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


def march_resumable_cuda(scene, origin: torch.Tensor,
                         direction: torch.Tensor, cfg: RenderConfig,
                         active=None, init=None,
                         counts: Optional[torch.Tensor] = None):
    """Budget-capped resumable march on the card through K1a-K1d.

    Same contract as ``ops/march.march_resumable``; returns the tuple
    ``(t, index, hit, fin, w, s, d, done)`` (f32, i32, bool, i32, f32, f32,
    f32, i32), each (N,). Raises NotImplementedError for variants no
    kernel serves. ``counts``: for K1c and K1d, an optional (2,) int64 CUDA
    tensor the kernel adds to: the MLP evaluations it ran (queue entries,
    with the rows that pad a warp) and the lane slots of its warps' march
    steps (32 a warp and step: the lane-trips a warp spent issue slots on);
    the render path passes none."""
    kind = variant(scene, cfg)
    if not (origin.is_cuda and direction.is_cuda):
        raise ValueError("march_resumable_cuda takes CUDA tensors")
    n = origin.shape[0]
    for name, v in (("origin", origin), ("direction", direction)):
        if v.shape != (n, 3) or v.dtype != torch.float32:
            raise ValueError(f"{name}: expected ({n}, 3) float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    if scene.position.dtype != torch.float32:
        # the kernels are f32: a float64 scene is refused, never cast
        raise ValueError(f"scene buffers: expected float32, got "
                         f"{scene.position.dtype}")
    if scene.position.device != origin.device:
        raise ValueError(f"scene on {scene.position.device}, rays on "
                         f"{origin.device}")
    lib = load(_SOURCE[kind])
    if scene.num_objects > lib.rt_march_max_objects():
        raise NotImplementedError(
            f"{scene.num_objects} objects; the kernel stages at most "
            f"{lib.rt_march_max_objects()} in shared memory")
    origin = origin.contiguous()
    direction = direction.contiguous()
    bound2, params, extra = scene_packs(scene, kind, cfg)
    pooled = kind in _POOLED
    # K1c/K1d: the shape types and the bunny's pack; K1a/K1b: the group
    # table, no bunny
    types, bunny = (scene.type_ids, extra) if pooled else (extra, None)
    if counts is not None and not (
            pooled and counts.shape == (2,) and counts.dtype == torch.int64
            and counts.device == origin.device):
        raise ValueError(f"counts: a (2,) int64 tensor on {origin.device} "
                         f"for K1c or K1d; got {tuple(counts.shape)} "
                         f"{counts.dtype} on {counts.device} for {kind}")
    act = None if active is None else _vec(active, n, torch.bool, "active")
    inits = (None,) * 4 if init is None else tuple(
        _vec(v, n, torch.float32, k) for v, k in zip(init, "twsd"))

    f32 = dict(dtype=torch.float32, device=origin.device)
    i32 = dict(dtype=torch.int32, device=origin.device)
    t, w, s, d = (torch.empty((n,), **f32) for _ in range(4))
    idx, fin, done = (torch.empty((n,), **i32) for _ in range(3))
    hit = torch.empty((n,), dtype=torch.bool, device=origin.device)

    if n == 0:
        return t, idx, hit, fin, w, s, d, done
    # the pool's counter of lanes handed out
    next_lane = (torch.zeros((1,), **i32) if pooled else None)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(origin.device):
        stream = torch.cuda.current_stream(origin.device).cuda_stream
        # c_float rounds each Python float to f32 as PyTorch rounds a
        # scalar operand of an f32 tensor op (the plain march's
        # ``s * (1.0 + 1e-6)`` included), so both compare the same values
        rc = lib.rt_march(
            ptr(params), ptr(types), ptr(bunny), scene.num_objects,
            scene.box_round, ptr(origin), ptr(direction), ptr(act),
            *(ptr(v) for v in inits), cfg.march_t0, cfg.omega,
            cfg.hit_precision, cfg.max_dis, cfg.pixel_radius, 1.0 + 1e-6,
            _POLICY[cfg.omega_policy], _CRIT[cfg.hit_criterion],
            int(bound2 is not None),
            cfg.max_raymarch, n, ptr(t), ptr(idx), ptr(hit), ptr(fin),
            ptr(w), ptr(s), ptr(d), ptr(done), ptr(next_lane), ptr(counts),
            POOL_SLOTS if pooled else ANALYTIC_BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"march kernel {kind} launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[kind] += 1
    if bound2 is not None:
        BOUND_LAUNCHES[kind] += 1
    return t, idx, hit, fin, w, s, d, done


def bunny_mlp_mxu(scene, points: torch.Tensor) -> torch.Tensor:
    """K1d's device MLP alone: the raw bunny MLP (no support test) of each
    of the (N, 3) f32 CUDA ``points``, evaluated a warp at a time on the
    tensor cores as inside the march. Its plain version is
    ``ops/sdf.bunny_mlp_eval``. For checking the kernel's MLP; not on any
    render path and not counted in :data:`LAUNCHES`."""
    n = points.shape[0]
    if (not points.is_cuda or points.shape != (n, 3)
            or points.dtype != torch.float32):
        raise ValueError(f"expected a CUDA (N, 3) float32 tensor, got "
                         f"{tuple(points.shape)} {points.dtype} on "
                         f"{points.device}")
    lib = load("march_mxu")
    pack = pack_bunny_mxu(scene).to(points.device).contiguous()
    points = points.contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.rt_bunny_mlp_mxu(pack.data_ptr(), points.data_ptr(),
                                  out.data_ptr(), n, BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"K1d MLP launch failed: CUDA error {rc}")
    return out
