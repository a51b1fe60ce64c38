"""Thin-lens camera rays (port of ``raytracingpbr_tpu/ops/camera.py``)."""
from __future__ import annotations

import torch

from ..core import rng as rnglib
from ..core.math import normalize, radians
from ..core.types import Camera, Rays


def get_ray(cam: Camera, uv: torch.Tensor, u1: torch.Tensor,
            u2: torch.Tensor) -> Rays:
    """Primary rays for film coordinates ``uv`` (N, 2) in [0, 1]^2: origin
    jittered on the aperture disk by ``u1``/``u2``, film plane at the focus
    distance."""
    theta = radians(cam.vfov)
    half_height = torch.tan(theta * 0.5)
    half_width = cam.aspect * half_height

    z = normalize(cam.lookfrom - cam.lookat)
    x = normalize(torch.linalg.cross(cam.vup, z))
    y = torch.linalg.cross(z, x)

    lens_radius = cam.aperture * 0.5
    rud = lens_radius * rnglib.in_unit_disk(u1, u2)  # (N, 2)
    offset = rud[:, :1] * x + rud[:, 1:2] * y

    hwfx = half_width * cam.focus * x
    hhfy = half_height * cam.focus * y
    lower_left = cam.lookfrom - hwfx - hhfy - cam.focus * z

    ro = cam.lookfrom + offset
    po = lower_left + uv[:, :1] * 2.0 * hwfx + uv[:, 1:2] * 2.0 * hhfy
    rd = normalize(po - ro)
    n = uv.shape[0]
    return Rays(origin=ro, direction=rd,
                color=torch.ones((n, 3), dtype=uv.dtype, device=uv.device),
                depth=torch.zeros((n,), dtype=torch.int32, device=uv.device))


def pixel_uv(pixel_id: torch.Tensor, width: int, height: int,
             jx: torch.Tensor, jy: torch.Tensor) -> torch.Tensor:
    """Flat pixel id (x-major: ``i * height + j``) -> jittered film uv."""
    i = torch.div(pixel_id, height, rounding_mode="floor").to(jx.dtype)
    j = torch.remainder(pixel_id, height).to(jx.dtype)
    return torch.stack([(i + jx) / width, (j + jy) / height], dim=-1)
