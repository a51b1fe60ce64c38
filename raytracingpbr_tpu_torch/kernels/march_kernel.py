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
(``utils/speedlight.march_bound``). K1a and K1b answer with one thread per
lane and a per-lane loop exit, the scene staged once per block in shared
memory. K1c and K1d share a persistent lane pool (``csrc/march_pool.cuh``):
as many blocks as fit on the card, each of :data:`POOL_SLOTS` slots that
take the next lane from a counter when their lane is done and march on
their own until their point lies inside a bunny's unit sphere; then a
compacted queue of those points, on which alone the MLP runs, spread over
the block (K1c: FP32 chains, an entry a thread; K1d: ``mma.sync``, 32
entries a warp).

The wrapper packs a scene for the kernels (:func:`scene_packs`) once per
``Scene`` object and keeps the packs on it: a frame's calls share them.

The plain PyTorch version is ``ops/march.march_resumable_plain``;
``ops/march.march_resumable`` sends CPU tensors there and CUDA tensors here.
This wrapper never falls back: a CUDA tensor is marched by a kernel, or the
call raises.
"""
from __future__ import annotations

import ctypes
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

# Kernel launches made by march_resumable_cuda, per variant: plain
# counters that a run resets and reads to show which path it went through.
LAUNCHES = {"k1a": 0, "k1b": 0, "k1c": 0, "k1d": 0}

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


def load(source: str = "march"):
    """Build if needed, then load ``csrc/<source>.cu`` and declare its C
    ABI (both march sources export ``rt_march``, ``rt_march_max_objects``
    and ``rt_pool_occupancy``; ``march_mxu`` also ``rt_bunny_mlp_mxu``)."""
    if source not in _libs:
        lib = build.load(source)
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
        _libs[source] = lib
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


def _pack_sources(scene):
    return ((scene.position, scene.scale, scene.matrix, scene.local_offset)
            + (tuple(scene.bunny) if scene.has_bunny else ()))


def scene_packs(scene, kind: str, cfg: RenderConfig):
    """``(bound2, params, bunny)`` for variant ``kind``'s kernel:
    ``scene.escape_bound2`` (None without the test), :func:`pack_scene`
    with it, and the bunny's pack (:func:`pack_bunny` for K1c,
    :func:`pack_bunny_mxu` for K1d, else None), each contiguous.

    Computed once per scene object and kept on it, so the calls of a frame
    share them and the packs die with the scene. ``make_scene``, ``bake``
    and ``animate`` return new scenes; a buffer the scene replaces
    (``scene.to``) is seen by identity, and one changed in place (``add_``,
    ``copy_``, an optimizer step) by its version counter: either packs
    anew."""
    key = (kind if kind in _POOLED else None,
           scenelib.has_escape_bound(scene, cfg))
    sources = _pack_sources(scene)
    versions = tuple(getattr(v, "_version", None) for v in sources)
    cache = scene.__dict__.setdefault("_march_packs", {})
    hit = cache.get(key)
    if (hit is not None and hit[1] == versions
            and all(a is b for a, b in zip(hit[0], sources))):
        return hit[2]
    bound2 = scenelib.escape_bound2(scene, cfg)
    params = pack_scene(scene, bound2).contiguous()
    pack = {"k1c": pack_bunny, "k1d": pack_bunny_mxu}.get(key[0])
    bunny = None if pack is None else pack(scene).contiguous()
    cache[key] = (sources, versions, (bound2, params, bunny))
    return bound2, params, bunny


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
    bound2, params, bunny = scene_packs(scene, kind, cfg)
    pooled = kind in _POOLED
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
            ptr(params), ptr(scene.type_ids), ptr(bunny), scene.num_objects,
            scene.box_round, ptr(origin), ptr(direction), ptr(act),
            *(ptr(v) for v in inits), cfg.march_t0, cfg.omega,
            cfg.hit_precision, cfg.max_dis, cfg.pixel_radius, 1.0 + 1e-6,
            _POLICY[cfg.omega_policy], _CRIT[cfg.hit_criterion],
            int(bound2 is not None),
            cfg.max_raymarch, n, ptr(t), ptr(idx), ptr(hit), ptr(fin),
            ptr(w), ptr(s), ptr(d), ptr(done), ptr(next_lane), ptr(counts),
            BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"march kernel {kind} launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES[kind] += 1
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
