"""The material gather's backward as one hand-written CUDA kernel
(``csrc/material_grad.cu``), its plain PyTorch version, and the wrapper
that chooses between them by device.

It replaces no TPU kernel: the JAX package's ``materials_at`` is a one-hot
matmul under XLA. ``ops/scene.materials_at`` gathers one row of the
(n_obj, 10) material table a lane; where a part of the table requires
grad, its backward is the gradient of each part as each object's sum over
its lanes. PyTorch's own backward (``index_select``'s ``index_add_``) adds
every lane's 10 columns into the table with float atomics, all of them
into one row on the bunny. The kernel sums each object's lanes of only
the parts that need a gradient, without contention, in a fixed order:
bit-reproducible from run to run. It is bound by the bytes of the index
and of the needed columns, read once.

:func:`material_grad` takes the kernel for CUDA tensors and
:func:`material_grad_plain` (``index_add_`` into a zero table a part, the
bits of ``index_select``'s backward) for CPU tensors; nothing falls back.
The kernel reads the index and each field gradient in place through its
strides, on torch's current stream, with no host sync.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import build

# the parts of the table and their widths, in ``ops/scene.Materials``' order
PART_NAMES = ("albedo", "emission", "roughness", "metallic", "transmission",
              "ior")
PART_WIDTHS = (3, 3, 1, 1, 1, 1)
_INDEX = (torch.int32, torch.int64)
# the partial sums' blocks at most: fixed, so the chunks (and the bits)
# depend on the lane count alone; four blocks of 256 threads on each of
# the H100's 132 SMs (the fastest of 132 to 2,112 blocks measured)
MAX_BLOCKS = 528
_BLOCK = 256  # threads a block (csrc/material_grad.cu's BLOCK)

# Kernel calls made by material_grad (see march_kernel.LAUNCHES): one a
# backward, each the blocks' partial sums and their combine.
LAUNCHES = {"material_grad": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load():
    """Build if needed, then load ``csrc/material_grad.cu``."""
    global _lib
    if _lib is None:
        lib = build.load("material_grad")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rt_material_grad.argtypes = [
            p, i, ll, ll, i, i, ctypes.POINTER(p), ctypes.POINTER(ll), ll, i,
            p, p, p]
        lib.rt_material_grad.restype = i
        lib.rt_material_grad_max_objects.argtypes = []
        lib.rt_material_grad_max_objects.restype = i
        _lib = lib
    return _lib


def layout(n: int) -> Tuple[int, int]:
    """``(blocks, chunk)`` of the partial sums over ``n`` lanes: at most
    :data:`MAX_BLOCKS` blocks of ``chunk`` consecutive lanes, a multiple
    of 32; (0, 0) for no lanes."""
    if n == 0:
        return 0, 0
    blocks = min(MAX_BLOCKS, -(-n // _BLOCK))
    per_block = -(-n // blocks)
    chunk = -(-per_block // 32) * 32
    return -(-n // chunk), chunk


def material_grad(idx: torch.Tensor,
                  grads: Sequence[Optional[torch.Tensor]],
                  needs: Sequence[bool], num_objects: int,
                  dtype: torch.dtype) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of each of the six parts (``PART_WIDTHS``) that
    ``needs`` one, None for the others: part j's ``(num_objects, k)`` (or
    ``(num_objects,)`` where ``k`` is 1) sum over the lanes of each object
    of ``grads[j]`` (``idx.shape + (k,)``, or ``idx.shape``; None reads as
    zeros), lane ``i`` to object ``idx[i]``. CUDA tensors take the kernel
    (:func:`material_grad_cuda`), CPU tensors :func:`material_grad_plain`."""
    if idx.is_cuda:
        return material_grad_cuda(idx, grads, needs, num_objects)
    return material_grad_plain(idx, grads, needs, num_objects, dtype)


def material_grad_plain(idx: torch.Tensor,
                        grads: Sequence[Optional[torch.Tensor]],
                        needs: Sequence[bool], num_objects: int,
                        dtype: torch.dtype
                        ) -> Tuple[Optional[torch.Tensor], ...]:
    """:func:`material_grad` in PyTorch: each needed part's
    ``index_add_`` into a zero ``(num_objects, k)`` table. On the CPU it
    adds a column's lanes in lane order, as ``index_select``'s backward
    did over the whole table, so the bits are that backward's."""
    ids = idx.reshape(-1).to(torch.int64)
    out = []
    for g, need, k in zip(grads, needs, PART_WIDTHS):
        if not need:
            out.append(None)
            continue
        s = torch.zeros((num_objects, k), dtype=dtype, device=idx.device)
        if g is not None:
            s.index_add_(0, ids, g.reshape(-1, k))
        out.append(s if k > 1 else s.reshape(num_objects))
    return tuple(out)


def _check(idx: torch.Tensor, flat: Sequence[Optional[torch.Tensor]],
           num_objects: int) -> None:
    """Raises ValueError on what the kernel does not take: an ``idx`` that
    is not a 1-D int32 or int64 CUDA tensor, a gradient that is not a
    float32 ``(n, k)`` tensor on that card, or more objects than the
    kernel's shared memory holds."""
    if not idx.is_cuda or idx.dtype not in _INDEX or idx.dim() != 1:
        raise ValueError(f"idx: a 1-D int32 or int64 CUDA tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    for g, k in zip(flat, PART_WIDTHS):
        if g is not None and (g.dtype != torch.float32
                              or g.device != idx.device
                              or g.shape != (idx.shape[0], k)):
            raise ValueError(f"a field gradient: float32 of shape "
                             f"({idx.shape[0]}, {k}) on {idx.device}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
    most = load().rt_material_grad_max_objects()
    if not 1 <= num_objects <= most:
        raise ValueError(f"the material gradient kernel takes 1 to {most} "
                         f"objects, got {num_objects}")


def material_grad_cuda(idx: torch.Tensor,
                       grads: Sequence[Optional[torch.Tensor]],
                       needs: Sequence[bool], num_objects: int
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """:func:`material_grad` on the card: one call of
    ``csrc/material_grad.cu`` over the needed parts' columns, float32,
    a new ``(num_objects, cols)`` tensor whose columns are the parts'
    gradients. Raises as :func:`_check` says."""
    ids = idx.reshape(-1)
    flat = [None if g is None else g.reshape(-1, k)
            for g, k in zip(grads, PART_WIDTHS)]
    _check(ids, flat, num_objects)
    cols, strides = [], []
    for g, need, k in zip(flat, needs, PART_WIDTHS):
        if not need:
            continue
        for c in range(k):
            cols.append(None if g is None else
                        g.data_ptr() + c * g.stride(1) * g.element_size())
            strides.append(0 if g is None else g.stride(0))
    width = len(cols)
    if width == 0:
        return (None,) * len(PART_WIDTHS)
    n = ids.shape[0]
    blocks, chunk = layout(n)
    partial = torch.empty((blocks, num_objects, width), dtype=torch.float32,
                          device=ids.device)
    out = torch.empty((num_objects, width), dtype=torch.float32,
                      device=ids.device)
    lib = load()
    with torch.cuda.device(ids.device):
        handle = torch.cuda.current_stream(ids.device).cuda_stream
        rc = lib.rt_material_grad(
            ids.data_ptr(), int(ids.dtype == torch.int64), ids.stride(0), n,
            num_objects, width, (ctypes.c_void_p * width)(*cols),
            (ctypes.c_longlong * width)(*strides), chunk, blocks,
            partial.data_ptr(), out.data_ptr(), handle)
    if rc != 0:
        raise RuntimeError(f"material gradient kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["material_grad"] += 1
    res, off = [], 0
    for need, k in zip(needs, PART_WIDTHS):
        if not need:
            res.append(None)
            continue
        res.append(out[:, off:off + k] if k > 1 else out[:, off])
        off += k
    return tuple(res)
