"""The surface normal as one hand-written CUDA kernel (``csrc/normal.cu``),
and its wrapper.

It replaces no TPU kernel: the JAX package's normal is ``jax.grad`` under
XLA. The port's first-order ``ops/scene.calc_normal`` evaluates every
object's distance at every lane and runs autograd's backward through all
of it (about 250 kernels a call on the tokyo scene, about a hundred more
over (N, 16) tensors for the bunny's MLP). The kernel takes one lane a
thread: the lane's own object alone, its SDF's gradient in closed form as
autograd's backward computes it, bit-equal to that normal
(``ops/scene.calc_normal_closed_plain`` is the same arithmetic in
PyTorch). It comes in two instances: the analytic shapes', bound by the
bytes of the points, the indices and the normals; and, for a scene that
holds the neural bunny, the same with the BUNNY case, whose lanes inside
the unit sphere run the sin-MLP's forward and backward written out
(1,120 FFMA, 32 ``sincosf`` and 16 ``cosf`` a lane: bound by operations),
the 624 weights staged in shared memory a block.

It reads the scene's buffers where they lie on the card, through their
strides (``scene.animate``'s offset is a broadcast view): no copy, no
host sync, on torch's current stream. ``ops/scene.calc_normal`` sends
float32 CUDA points here; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.sdf import SHAPE, BunnyMLP
from . import build

_INDEX = (torch.int32, torch.int64)

# Kernel launches made by calc_normal (see march_kernel.LAUNCHES): the
# analytic instance, and the instance with the BUNNY case
LAUNCHES = {"normal": 0, "normal_bunny": 0}

# ops/sdf.BunnyMLP's parts that the gradient reads (all but bias_out), and
# their shapes
_MLP_SHAPES = ((3, 16), (16,), (16, 16), (16,), (16, 16), (16,), (16,))

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load():
    """Build if needed, then load ``csrc/normal.cu``."""
    global _lib
    if _lib is None:
        lib = build.load("normal")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rt_normal.argtypes = [p, p, i, p, ll, i, i, p, ll, ll, p, ll,
                                  ll, ll, p, ll, ll, p, ll, ll, p, ll, p, p,
                                  p]
        lib.rt_normal.restype = i
        _lib = lib
    return _lib


def _check(scene, idx: torch.Tensor, p: torch.Tensor) -> None:
    """Raises ValueError on what the kernel does not take: a ``p`` that is
    not a float32 CUDA tensor of shape (..., 3), an ``idx`` that is not an
    int32 or int64 tensor of ``p.shape[:-1]`` on ``p``'s card, or a scene
    buffer that is not float32 (``type_ids`` int32) on that card, the
    bunny's weights among them, each of its shape."""
    if not p.is_cuda or p.dtype != torch.float32 or p.shape[-1:] != (3,):
        raise ValueError(f"p: a float32 CUDA tensor of shape (..., 3), got "
                         f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if (idx.dtype not in _INDEX or idx.device != p.device
            or idx.shape != p.shape[:-1]):
        raise ValueError(f"idx: an int32 or int64 tensor of shape "
                         f"{tuple(p.shape[:-1])} on {p.device}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    for name in ("position", "matrix", "local_offset", "scale"):
        t = getattr(scene, name)
        if t.dtype != torch.float32 or t.device != p.device:
            raise ValueError(f"scene.{name}: float32 on {p.device}, got "
                             f"{t.dtype} on {t.device}")
    for name, t, shape in zip(BunnyMLP._fields, scene.bunny or (),
                              _MLP_SHAPES):
        if (t.dtype != torch.float32 or t.device != p.device
                or t.shape != shape):
            raise ValueError(f"scene.bunny_{name}: float32 {shape} on "
                             f"{p.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if scene.type_ids.dtype != torch.int32 or (
            scene.type_ids.device != p.device):
        raise ValueError(f"scene.type_ids: int32 on {p.device}")


def num_curved(scene) -> int:
    """The scene's objects whose gradient reads the point: SPHERE, BOX,
    CYLINDER, CONE and BUNNY (``ops/sdf.SHAPE`` 1-4 and 6)."""
    return sum(1 <= t <= 4 or t == SHAPE.BUNNY for t in scene.shape_types)


def _mlp_args(scene):
    """The bunny's parts for ``rt_normal`` (two ctypes arrays: the
    pointers, the (row, column) element strides, row 0 for a vector), or
    two nulls for a scene without it."""
    if not scene.has_bunny:
        return None, None
    parts = scene.bunny[:len(_MLP_SHAPES)]
    ptrs = (ctypes.c_void_p * len(parts))(*(t.data_ptr() for t in parts))
    strides = (ctypes.c_longlong * (2 * len(parts)))(*(
        s for t in parts for s in (t.stride() if t.dim() == 2
                                   else (0, t.stride(0)))))
    return ptrs, strides


def calc_normal(scene, idx: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The first-order normal of ``ops/scene.calc_normal`` at the points
    ``p`` (..., 3) of the objects ``idx`` (...,): one launch, of the
    instance with the BUNNY case where the scene has the bunny, a new
    (..., 3) float32 tensor. Raises as :func:`_check` says."""
    _check(scene, idx, p)
    pf = p.reshape(-1, 3).contiguous()
    ids = idx.reshape(-1).contiguous()
    out = torch.empty_like(pf)
    n = pf.shape[0]
    if n:
        lib = load()
        pos, mat, off, scl, typ = (scene.position, scene.matrix,
                                   scene.local_offset, scene.scale,
                                   scene.type_ids)
        mlp_ptrs, mlp_strides = _mlp_args(scene)
        with torch.cuda.device(p.device):
            handle = torch.cuda.current_stream(p.device).cuda_stream
            rc = lib.rt_normal(
                pf.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                out.data_ptr(), n, scene.num_objects, num_curved(scene),
                pos.data_ptr(), *pos.stride(), mat.data_ptr(), *mat.stride(),
                off.data_ptr(), *off.stride(), scl.data_ptr(), *scl.stride(),
                typ.data_ptr(), *typ.stride(), mlp_ptrs, mlp_strides, handle)
        if rc != 0:
            raise RuntimeError(f"normal kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES["normal_bunny" if scene.has_bunny else "normal"] += 1
    return out.reshape(p.shape)
