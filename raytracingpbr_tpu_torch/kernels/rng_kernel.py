"""The counter RNG as one hand-written CUDA kernel a draw
(``csrc/rng.cu``), and its wrapper.

It replaces no TPU kernel: the JAX package's ``core/rng.py`` is XLA. The
port's plain draws (``core/rng.uniform4_plain``, ``uniform_plain``,
``r2_uniform4_plain``) hold each uint32 word in an int64 tensor and mask
after every add and multiply, about 140 elementwise kernels a draw. The
kernel hashes a lane's counter with pcg4d in native ``uint32_t`` (adding
the R2 rotation where asked) and writes the floats, bit-equal to the plain
draw; it is bound by the bytes it reads and writes (the ids, a per-lane
step where there is one, and the floats).

:func:`draw` takes every form of ``step`` the port passes, none with a
host sync: a Python int (by value), a tensor of one element on the ids'
card (read on the card, so a frame counter held there stays there), or
one step a lane. ``core/rng`` sends CUDA tensors here and CPU tensors to
the plain draws; nothing falls back.
"""
from __future__ import annotations

import ctypes
import numbers
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

_MASK = 0xFFFFFFFF
# csrc/rng.cu's StepKind: where a draw's step word comes from
STEP_VALUE, STEP_I32, STEP_I64 = 0, 1, 2
_INDEX = {torch.int32: STEP_I32, torch.int64: STEP_I64}
_OUT = (torch.float32, torch.float64)

# Kernel launches made by draw, by mode (see march_kernel.LAUNCHES).
LAUNCHES = {"uniform4": 0, "r2_uniform4": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load():
    """Build if needed, then load ``csrc/rng.cu``."""
    global _lib
    if _lib is None:
        lib = build.load("rng")
        p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint)
        lib.rt_rng.argtypes = [p, i, p, i, ll, u, u, u, i, p, p, p, p, i, ll,
                               p]
        lib.rt_rng.restype = i
        _lib = lib
    return _lib


class Plan(NamedTuple):
    """A draw's arguments as the kernel takes them."""
    n: int
    step: Optional[torch.Tensor]  # None: ``step_value`` for every lane
    step_kind: int
    step_stride: int  # 0: one step for every lane, 1: one a lane
    step_value: int
    stream: int
    seed: int


def _word(x, name: str) -> int:
    if not isinstance(x, numbers.Integral):
        raise TypeError(f"{name}: a Python int, got {type(x).__name__}")
    return int(x) & _MASK


def plan(pixel_id: torch.Tensor, step, stream, seed,
         dtype=torch.float32) -> Plan:
    """Checks a draw's arguments on the host and returns what the kernel
    takes; touches no device. Raises TypeError on a ``pixel_id`` or
    tensor ``step`` that is not int32 or int64, a ``step`` that is neither
    an int nor a tensor, a ``stream`` or ``seed`` that is not an int, or a
    ``dtype`` other than float32 or float64; ValueError on a tensor that
    is not contiguous, a ``step`` tensor on another device than
    ``pixel_id`` or with neither one element nor ``pixel_id``'s shape."""
    if not isinstance(pixel_id, torch.Tensor) or pixel_id.dtype not in _INDEX:
        raise TypeError(f"pixel_id: an int32 or int64 tensor, got "
                        f"{getattr(pixel_id, 'dtype', type(pixel_id))}")
    if dtype not in _OUT:
        raise TypeError(f"dtype: float32 or float64, got {dtype}")
    if not pixel_id.is_contiguous():
        raise ValueError(f"pixel_id: a contiguous tensor, got strides "
                         f"{pixel_id.stride()}")
    n = pixel_id.numel()
    words = dict(stream=_word(stream, "stream"), seed=_word(seed, "seed"))
    if isinstance(step, numbers.Integral):
        return Plan(n, None, STEP_VALUE, 0, int(step) & _MASK, **words)
    if not isinstance(step, torch.Tensor):
        raise TypeError(f"step: an int or an integer tensor, got "
                        f"{type(step).__name__}")
    if step.dtype not in _INDEX:
        raise TypeError(f"step: an int32 or int64 tensor, got {step.dtype}")
    if step.device != pixel_id.device:
        raise ValueError(f"step on {step.device}, pixel_id on "
                         f"{pixel_id.device}")
    if step.numel() == 1:
        return Plan(n, step, _INDEX[step.dtype], 0, 0, **words)
    if step.shape != pixel_id.shape:
        raise ValueError(f"step: one element or pixel_id's shape "
                         f"{tuple(pixel_id.shape)}, got {tuple(step.shape)}")
    if not step.is_contiguous():
        raise ValueError(f"step: a contiguous tensor, got strides "
                         f"{step.stride()}")
    return Plan(n, step, _INDEX[step.dtype], 1, 0, **words)


def draw(pixel_id: torch.Tensor, step, stream, seed=0, dtype=torch.float32,
         rows: int = 4, r2: bool = False) -> Tuple[torch.Tensor, ...]:
    """One draw of each lane of the CUDA tensor ``pixel_id``: the first
    ``rows`` (1 or 4) uniforms of ``uniform4`` (``r2``: of
    ``r2_uniform4``), each a tensor of ``pixel_id``'s shape in ``dtype``
    and an allocation of its own, as the plain draw's outputs are.
    Arguments as :func:`plan`; raises ValueError on a CPU ``pixel_id``."""
    if not pixel_id.is_cuda:
        raise ValueError(f"pixel_id on {pixel_id.device}: the kernel takes "
                         f"CUDA tensors (the plain draws in core/rng take "
                         f"the CPU's)")
    if rows not in (1, 4):
        raise ValueError(f"rows: 1 or 4, got {rows}")
    p = plan(pixel_id, step, stream, seed, dtype)
    out = tuple(torch.empty(pixel_id.shape, dtype=dtype,
                            device=pixel_id.device) for _ in range(rows))
    if p.n:
        lib = load()
        with torch.cuda.device(pixel_id.device):
            handle = torch.cuda.current_stream(pixel_id.device).cuda_stream
            rc = lib.rt_rng(
                pixel_id.data_ptr(), int(pixel_id.dtype == torch.int64),
                None if p.step is None else p.step.data_ptr(),
                p.step_kind, p.step_stride, p.step_value, p.stream, p.seed,
                int(r2), *(o.data_ptr() for o in out), *(None,) * (4 - rows),
                int(dtype == torch.float64), p.n, handle)
        if rc != 0:
            raise RuntimeError(f"rng kernel launch failed: CUDA error {rc}")
        LAUNCHES["r2_uniform4" if r2 else "uniform4"] += 1
    return out
