"""The analytic surface normal as one hand-written CUDA kernel
(``csrc/normal.cu``), and its wrapper.

It replaces no TPU kernel: the JAX package's normal is ``jax.grad`` under
XLA. The port's first-order ``ops/scene.calc_normal`` evaluates every
object's distance at every lane and runs autograd's backward through all
of it (about 250 kernels a call on the tokyo scene). The kernel takes one
lane a thread: the lane's own object alone, its SDF's gradient in closed
form as autograd's backward computes it, bit-equal to that normal
(``ops/scene.calc_normal_closed_plain`` is the same arithmetic in
PyTorch). It is bound by the bytes of the points, the indices and the
normals.

It reads the scene's buffers where they lie on the card, through their
strides (``scene.animate``'s offset is a broadcast view): no copy, no
host sync, on torch's current stream. ``ops/scene.calc_normal`` sends
float32 CUDA points of a scene without a BUNNY here; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_INDEX = (torch.int32, torch.int64)

# Kernel launches made by calc_normal (see march_kernel.LAUNCHES).
LAUNCHES = {"normal": 0}

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
                                  ll, ll, p, ll, ll, p, ll, ll, p, ll, p]
        lib.rt_normal.restype = i
        _lib = lib
    return _lib


def _check(scene, idx: torch.Tensor, p: torch.Tensor) -> None:
    """Raises ValueError on what the kernel does not take: a ``p`` that is
    not a float32 CUDA tensor of shape (..., 3), an ``idx`` that is not an
    int32 or int64 tensor of ``p.shape[:-1]`` on ``p``'s card, a scene
    with a BUNNY, or a scene buffer that is not float32 (``type_ids``
    int32) on that card."""
    if not p.is_cuda or p.dtype != torch.float32 or p.shape[-1:] != (3,):
        raise ValueError(f"p: a float32 CUDA tensor of shape (..., 3), got "
                         f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if (idx.dtype not in _INDEX or idx.device != p.device
            or idx.shape != p.shape[:-1]):
        raise ValueError(f"idx: an int32 or int64 tensor of shape "
                         f"{tuple(p.shape[:-1])} on {p.device}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    if scene.has_bunny:
        raise ValueError("the normal kernel takes analytic shapes; a BUNNY "
                         "scene's normal is autograd's")
    for name in ("position", "matrix", "local_offset", "scale"):
        t = getattr(scene, name)
        if t.dtype != torch.float32 or t.device != p.device:
            raise ValueError(f"scene.{name}: float32 on {p.device}, got "
                             f"{t.dtype} on {t.device}")
    if scene.type_ids.dtype != torch.int32 or (
            scene.type_ids.device != p.device):
        raise ValueError(f"scene.type_ids: int32 on {p.device}")


def num_curved(scene) -> int:
    """The scene's objects whose gradient reads the point: SPHERE, BOX,
    CYLINDER and CONE (``ops/sdf.SHAPE`` 1-4)."""
    return sum(1 <= t <= 4 for t in scene.shape_types)


def calc_normal(scene, idx: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The first-order normal of ``ops/scene.calc_normal`` at the points
    ``p`` (..., 3) of the objects ``idx`` (...,): one launch, a new
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
        with torch.cuda.device(p.device):
            handle = torch.cuda.current_stream(p.device).cuda_stream
            rc = lib.rt_normal(
                pf.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                out.data_ptr(), n, scene.num_objects, num_curved(scene),
                pos.data_ptr(), *pos.stride(), mat.data_ptr(), *mat.stride(),
                off.data_ptr(), *off.stride(), scl.data_ptr(), *scl.stride(),
                typ.data_ptr(), *typ.stride(), handle)
        if rc != 0:
            raise RuntimeError(f"normal kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES["normal"] += 1
    return out.reshape(p.shape)
