"""SDF primitives (port of ``raytracingpbr_tpu/ops/sdf.py``).

Every ``sd_*`` takes ``p`` (..., 3) and parameters (..., 3) and returns
(...,) distances. The arithmetic follows the CUDA march kernel
(``csrc/march.cu``) operation for operation, so the plain march and the
kernel agree bit for bit on the card. Maxima go through ``torch.amax`` and
``torch.maximum``/``torch.minimum``, whose gradients split evenly at ties
as JAX's do (box edges and corners are ties), for ``calc_normal``.

The neural bunny has two forms of one MLP: ``bunny_mlp_eval`` with
``torch.matmul`` (the JAX package's form, for ``sd_object`` and the
autograd normal) and ``bunny_mlp_eval_unrolled``, written out in the march
kernel's order of operations (the plain march's form, bit-equal to the
kernel on the card).
"""
from __future__ import annotations

import enum
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve
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


# --- neural bunny -----------------------------------------------------------

_ASSET = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "assets", "bunny_mlp.npz"))


class BunnyMLP(NamedTuple):
    """Sin-activated MLP encoding the Stanford bunny SDF, 3->16->16->16->1
    (weights in ``assets/bunny_mlp.npz``)."""

    w_in: torch.Tensor      # (3, 16)
    b_in: torch.Tensor      # (16,)
    w_h1: torch.Tensor      # (16, 16)
    b_h1: torch.Tensor      # (16,)
    w_h2: torch.Tensor      # (16, 16)
    b_h2: torch.Tensor      # (16,)
    w_out: torch.Tensor     # (16,)
    bias_out: torch.Tensor  # ()


def load_bunny(device=None, dtype=torch.float32) -> BunnyMLP:
    """The trained weights from ``assets/bunny_mlp.npz``."""
    device = resolve(device)
    with np.load(_ASSET) as z:
        return BunnyMLP(**{k: torch.tensor(z[k], dtype=dtype, device=device)
                           for k in BunnyMLP._fields})


def bunny_mlp_eval(mlp: BunnyMLP, p: torch.Tensor) -> torch.Tensor:
    """Raw MLP distance (valid inside the unit sphere); ``(..., 3) ->
    (...)``. Full f32 contractions: on the card this needs
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default)."""
    f0 = torch.sin(p @ mlp.w_in + mlp.b_in)
    f1 = torch.sin(f0 @ mlp.w_h1 + mlp.b_h1) + f0
    f2 = torch.sin(f1 @ mlp.w_h2 + mlp.b_h2) / 1.4 + f1
    return f2 @ mlp.w_out + mlp.bias_out


def _chain(f: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``f @ w`` as the kernel computes it: for each output unit a
    left-to-right chain ``f[0]*w[0] + f[1]*w[1] + ...``, every product and
    sum rounded on its own."""
    acc = f[..., 0:1] * w[0]
    for j in range(1, w.shape[0]):
        acc = acc + f[..., j:j + 1] * w[j]
    return acc


def bunny_mlp_eval_unrolled(mlp: BunnyMLP, px, py, pz) -> torch.Tensor:
    """``bunny_mlp_eval`` in the march kernel's operation order, on
    unpacked coordinates (any shape): the first layer as ``px*w0 + py*w1 +
    pz*w2 + b``, each contraction as a left-to-right chain, and the second
    residual scaled by ``(1.0 / 1.4)`` (a multiply, as the kernel does;
    ``bunny_mlp_eval`` divides). Features run on a trailing axis of 16, so
    a call is about 100 elementwise launches."""
    px, py, pz = px[..., None], py[..., None], pz[..., None]
    w = mlp.w_in
    f0 = torch.sin(px * w[0] + py * w[1] + pz * w[2] + mlp.b_in)
    f1 = torch.sin(_chain(f0, mlp.w_h1) + mlp.b_h1) + f0
    f2 = torch.sin(_chain(f1, mlp.w_h2) + mlp.b_h2) * (1.0 / 1.4) + f1
    return _chain(f2, mlp.w_out[:, None])[..., 0] + mlp.bias_out


def sd_bunny(p: torch.Tensor, mlp: BunnyMLP) -> torch.Tensor:
    """Bunny SDF with the unit-sphere guard: outside ``|p| > 1`` it is
    ``|p| - 0.8``."""
    r = safe_norm(p)
    return torch.where(r > 1.0, r - 0.8, bunny_mlp_eval(mlp, p))


def sd_bunny_unrolled(px, py, pz, mlp: BunnyMLP) -> torch.Tensor:
    """``sd_bunny`` in the march kernel's order: ``r`` as
    ``sqrt(px*px + py*py + pz*pz)``, the MLP as
    ``bunny_mlp_eval_unrolled``."""
    r = torch.sqrt(px * px + py * py + pz * pz)
    return torch.where(r > 1.0, r - 0.8,
                       bunny_mlp_eval_unrolled(mlp, px, py, pz))


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
