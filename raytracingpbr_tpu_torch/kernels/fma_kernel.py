"""Hand-written CUDA kernel K2 (``csrc/speedlight.cu``), the card's FP32
FMA roof, with its wrapper and its plain version.

It replaces the Pallas TPU kernel
``raytracingpbr_tpu/utils/speedlight.py::_fma_chains_kernel``: per lane,
``chains`` accumulators start at ``x * (1 + 0.001 k)``, ``a = x * 0.25 +
0.5``, ``iters`` trips of ``unroll`` dependent ``acc * a + 0.125`` on every
chain, then the chains are summed. On the H100 the kernel issues each step
as one FFMA (``fmaf``), so its rate is the FP32 FFMA roof that
``utils/speedlight.measure_vpu_peak`` reports; a thread reads and writes
one float, so nothing but FFMA issue bounds it.

:func:`fma_chains` runs the kernel on CUDA tensors and the plain version
on CPU tensors; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

BLOCK = 256
# (chains, unroll) pairs compiled into csrc/speedlight.cu
SHAPES = ((8, 4), (16, 4), (32, 4), (32, 1))

# Kernel launches made by fma_chains (see march_kernel.LAUNCHES).
LAUNCHES = {"k2": 0}

_lib = None


def reset_launches() -> None:
    LAUNCHES["k2"] = 0


def load():
    """Build if needed, then load ``csrc/speedlight.cu``."""
    global _lib
    if _lib is None:
        lib = build.load("speedlight")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_fma_chains.argtypes = [p, p, i, i, i, i, i, p]
        lib.rt_fma_chains.restype = i
        _lib = lib
    return _lib


def fma_chains_plain(x: torch.Tensor, iters: int, chains: int,
                     unroll: int) -> torch.Tensor:
    """The same recurrence in PyTorch, each step a multiply then an add
    (two roundings where the kernel's FFMA rounds once). The recurrence
    contracts towards ``0.125 / (1 - a)`` (``a`` <= 0.75 for x in [0, 1]),
    so the two stay within a few ulps however long they run."""
    scale = torch.tensor([1.0 + 0.001 * k for k in range(chains)],
                         dtype=x.dtype, device=x.device)
    acc = x[None, :] * scale[:, None]
    a = x * 0.25 + 0.5
    for _ in range(iters * unroll):
        acc = acc * a + 0.125
    out = acc[0]
    for k in range(1, chains):
        out = out + acc[k]
    return out


def fma_chains(x: torch.Tensor, iters: int, chains: int,
               unroll: int) -> torch.Tensor:
    """Summed FMA chains of each lane of the (N,) f32 ``x``: K2 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"expected an (N,) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_cuda:
        return fma_chains_plain(x, iters, chains, unroll)
    if (chains, unroll) not in SHAPES:
        raise NotImplementedError(f"K2 is compiled for (chains, unroll) in "
                                  f"{SHAPES}, not ({chains}, {unroll})")
    lib = load()
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rt_fma_chains(x.data_ptr(), out.data_ptr(), x.shape[0],
                               iters, chains, unroll, BLOCK, stream)
    if rc != 0:
        raise RuntimeError(f"fma kernel K2 launch failed: CUDA error {rc}")
    LAUNCHES["k2"] += 1
    return out
