"""Deterministic counter-based RNG (port of ``raytracingpbr_tpu/core/rng.py``).

The pcg4d hash maps a 4-word counter ``(pixel_id, step, stream, seed)`` to 4
uniform words, so every draw is a pure function of its counter and the
renderer needs no ``torch.Generator``. Results are bit-exact against the JAX
package.

:func:`uniform4`, :func:`uniform` and :func:`r2_uniform4` send CUDA tensors
to the hand-written kernel (``kernels/rng_kernel``: one launch a draw, no
host sync) and CPU tensors to the plain draws below (``*_plain``), which
are also the kernel's reference; the kernel is bit-equal to them.

PyTorch has no complete uint32 arithmetic, so the plain words live in
int64 tensors holding values in [0, 2**32), masked after every add and
multiply. A product of two such words can exceed 2**63, so ``_mul32``
splits one factor into 16-bit halves: every partial product stays below
2**49 and the low 32 bits are exact without relying on signed
wrap-around.
"""
from __future__ import annotations

import math

import torch

from ..kernels import rng_kernel
from ..utils.profiling import traced

_MASK = 0xFFFFFFFF
_PCG_MULT = 1664525
_PCG_INC = 1013904223
# 1/2^24: the top 24 bits of a word map exactly to a float32 in [0, 1).
_INV_2_24 = 1.0 / (1 << 24)


def _u32(x, like: torch.Tensor) -> torch.Tensor:
    """Counter word as int64 in [0, 2**32), broadcast to ``like``'s shape
    and device. A Python int is filled in on the device: a tensor made
    from it on the host would be copied over with a host sync."""
    if isinstance(x, int):
        return torch.full(like.shape, x & _MASK, dtype=torch.int64,
                          device=like.device)
    x = torch.as_tensor(x, device=like.device)
    return torch.broadcast_to(x.to(torch.int64) & _MASK, like.shape)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for words a, b in [0, 2**32)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg4d(x, y, z, w):
    """pcg4d hash: four counter words -> four uniform words (int64 tensors
    holding uint32 values)."""
    x = x & _MASK
    y = y & _MASK
    z = z & _MASK
    w = w & _MASK

    x = (_mul32(x, _PCG_MULT) + _PCG_INC) & _MASK
    y = (_mul32(y, _PCG_MULT) + _PCG_INC) & _MASK
    z = (_mul32(z, _PCG_MULT) + _PCG_INC) & _MASK
    w = (_mul32(w, _PCG_MULT) + _PCG_INC) & _MASK

    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return x, y, z, w


def _to_unit_float(u: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Word -> [0, 1) from its top 24 bits (exact in float32)."""
    return (u >> 8).to(dtype) * _INV_2_24


def uniform4_plain(pixel_id: torch.Tensor, step, stream: int, seed: int = 0,
                   dtype=torch.float32):
    """:func:`uniform4` in plain PyTorch on int64 words."""
    a, b, c, d = pcg4d(_u32(pixel_id, pixel_id), _u32(step, pixel_id),
                       _u32(stream, pixel_id), _u32(seed, pixel_id))
    return tuple(_to_unit_float(v, dtype) for v in (a, b, c, d))


def uniform_plain(pixel_id, step, stream, seed=0, dtype=torch.float32):
    """:func:`uniform` in plain PyTorch on int64 words."""
    return uniform4_plain(pixel_id, step, stream, seed, dtype)[0]


@traced("rng")
def uniform4(pixel_id: torch.Tensor, step, stream: int, seed: int = 0,
             dtype=torch.float32):
    """Four independent uniforms in [0, 1) per counter.

    ``pixel_id``: integer tensor (the batch); ``step``: int or integer
    tensor broadcastable to it; ``stream``: use-site id; ``seed``: global
    seed in the fourth word."""
    if pixel_id.is_cuda:
        return rng_kernel.draw(pixel_id, step, stream, seed, dtype)
    return uniform4_plain(pixel_id, step, stream, seed, dtype)


@traced("rng")
def uniform(pixel_id, step, stream, seed=0, dtype=torch.float32):
    """One uniform per counter (the first pcg4d word)."""
    if pixel_id.is_cuda:
        return rng_kernel.draw(pixel_id, step, stream, seed, dtype,
                               rows=1)[0]
    return uniform_plain(pixel_id, step, stream, seed, dtype)


# 4D R2 sequence (Roberts 2018) in uint32 fixed point, Cranley-Patterson
# rotated per (pixel, stream, seed).
_PHI4 = 1.1673039782614187  # root of x^5 = x + 1
_R2_A = tuple(int(round(((1.0 / _PHI4) ** (k + 1) % 1.0) * 2.0**32))
              & _MASK for k in range(4))
_R2_Y = 0x9E3779B9


def r2_uniform4_plain(pixel_id: torch.Tensor, step, stream: int,
                      seed: int = 0, dtype=torch.float32):
    """:func:`r2_uniform4` in plain PyTorch on int64 words."""
    n = _u32(step, pixel_id)
    rot = pcg4d(_u32(pixel_id, pixel_id), _u32(_R2_Y, pixel_id),
                _u32(stream, pixel_id), _u32(seed, pixel_id))
    return tuple(_to_unit_float((rot[k] + _mul32(n, _R2_A[k])) & _MASK,
                                dtype)
                 for k in range(4))


@traced("rng")
def r2_uniform4(pixel_id: torch.Tensor, step, stream: int, seed: int = 0,
                dtype=torch.float32):
    """The ``step``-th point of the 4D R2 sequence, rotated per pixel:
    signature-compatible with :func:`uniform4`, stratified across steps of
    a per-pixel sample counter."""
    if pixel_id.is_cuda:
        return rng_kernel.draw(pixel_id, step, stream, seed, dtype, r2=True)
    return r2_uniform4_plain(pixel_id, step, stream, seed, dtype)


def sampler4(low_discrepancy: bool):
    """The four-uniform sampler for draws indexed by a per-pixel sample
    counter: :func:`r2_uniform4` under ``low_discrepancy``, else
    :func:`uniform4`."""
    return r2_uniform4 if low_discrepancy else uniform4


def in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """sqrt-radius disk sample -> (..., 2): ``sqrt(u1) * (sin a, cos a)``
    with ``a = 2 pi u2``."""
    a = u2 * (2.0 * math.pi)
    r = torch.sqrt(u1)
    return torch.stack([r * torch.sin(a), r * torch.cos(a)], dim=-1)


def in_unit_sphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere (the reference's name; it
    samples the surface)."""
    z = 2.0 * u1 - 1.0
    a = u2 * (2.0 * math.pi)
    xy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([xy * torch.sin(a), xy * torch.cos(a), z], dim=-1)


def hemispheric(normal: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere about ``normal``:
    normalize(normal + uniform sphere sample)."""
    s = normal + in_unit_sphere(u1, u2)
    return s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)
