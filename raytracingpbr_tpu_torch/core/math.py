"""Math utilities (port of ``raytracingpbr_tpu/core/math.py``).

Vectors are ``(..., 3)`` tensors. Sums over a short last axis are written
out component by component: the order of the adds is then fixed, the same
on every device, and the same as the CUDA march kernel's.
"""
from __future__ import annotations

import math

import torch

_LUMA = (0.299, 0.587, 0.114)  # BT.601 luma weights


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the (short) last axis."""
    acc = v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def brightness(rgb: torch.Tensor) -> torch.Tensor:
    """Luma dot product."""
    return (rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1]
            + rgb[..., 2] * _LUMA[2])


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _sum_last(a * b)


def safe_norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis with a zero (not NaN) gradient at
    ``v = 0``: SDF branches selected by ``where`` stay finite under
    autograd."""
    sq = _sum_last(v * v)
    pos = sq > 0
    safe = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return torch.where(pos, safe, torch.zeros_like(sq))


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def rotate_euler(angles: torch.Tensor) -> torch.Tensor:
    """Euler angles (radians, ``(..., 3)``) -> rotation ``(..., 3, 3)``,
    composed Rz @ Ry @ Rx with the reference's row-major sign convention."""
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


def radians(deg):
    return deg * (math.pi / 180.0)


def mix(a, b, t):
    """GLSL mix / lerp."""
    return a + (b - a) * t
