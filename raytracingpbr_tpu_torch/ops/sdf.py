"""SDF primitives (port of ``raytracingpbr_tpu/ops/sdf.py``).

Every ``sd_*`` takes ``p`` (..., 3) and parameters (..., 3) and returns
(...,) distances. The arithmetic follows the CUDA march kernel
(``csrc/march.cu``) operation for operation, so the plain march and the
kernel agree bit for bit on the card. Maxima go through ``torch.amax`` and
``torch.maximum``/``torch.minimum``, whose gradients split evenly at ties
as JAX's do (box edges and corners are ties), for ``calc_normal``.

The neural bunny waits for a later port: ``SHAPE.BUNNY`` raises.
"""
from __future__ import annotations

import enum

import torch

from ..core.math import radians, rotate_euler, safe_norm

MAX_DIS = 1e3


class SHAPE(enum.IntEnum):
    """Shape ids (the JAX package's, bunny included)."""

    NONE = 0
    SPHERE = 1
    BOX = 2
    CYLINDER = 3
    CONE = 4
    PLANE = 5
    BUNNY = 6


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x)


def sd_none(p, s):
    """Always-far dummy."""
    return torch.full(p.shape[:-1], MAX_DIS, dtype=p.dtype, device=p.device)


def sd_sphere(p, s):
    """Sphere of radius ``s.x``."""
    return safe_norm(p) - s[..., 0]


def sd_round_box(p, s, round_radius=0.03):
    """Box with half-extents ``s``, rounded by ``round_radius``."""
    q = torch.abs(p) - s
    outside = safe_norm(torch.maximum(q, _zero(q)))
    inner = torch.amax(q, dim=-1)
    inside = torch.minimum(inner, _zero(inner))
    return outside + inside - round_radius


def sd_box(p, s):
    """Sharp box."""
    return sd_round_box(p, s, 0.0)


def sd_cylinder(p, s):
    """Capped cylinder, radius ``s.x``, half-height ``s.y``."""
    dxz = safe_norm(p[..., ::2])
    d = torch.abs(torch.stack([dxz, p[..., 1]], -1)) - s[..., :2]
    inner = torch.amax(d, dim=-1)
    return (torch.minimum(inner, _zero(inner))
            + safe_norm(torch.maximum(d, _zero(d))))


def sd_cone(p, s):
    """Infinite cone bound (axis parameters in ``s.x``, ``s.z``)."""
    q = safe_norm(p[..., ::2])
    d = s[..., 0] * q + s[..., 2] * p[..., 1]
    return torch.maximum(d, -s[..., 1] - p[..., 1])


def sd_plane(p, s):
    """Horizontal plane at height ``s.y``."""
    return p[..., 1] - s[..., 1]


SHAPE_FUNC = {
    SHAPE.NONE: sd_none,
    SHAPE.SPHERE: sd_sphere,
    SHAPE.BOX: sd_round_box,
    SHAPE.CYLINDER: sd_cylinder,
    SHAPE.CONE: sd_cone,
    SHAPE.PLANE: sd_plane,
}


def to_object_space(p, position, matrix, offset=None):
    """World point -> object frame: translate, rotate (row products written
    out in the kernel's order), then the animation offset.

    ``p``, ``position``, ``offset``: (..., 3); ``matrix``: (..., 3, 3)."""
    q = p - position
    rows = []
    for r in range(3):
        v = (matrix[..., r, 0] * q[..., 0] + matrix[..., r, 1] * q[..., 1]
             + matrix[..., r, 2] * q[..., 2])
        if offset is not None:
            v = v + offset[..., r]
        rows.append(v)
    return torch.stack(rows, -1)


def bake_matrices(rotation_deg: torch.Tensor) -> torch.Tensor:
    """Euler degrees (n, 3) -> rotation matrices (n, 3, 3)."""
    return rotate_euler(radians(rotation_deg))
