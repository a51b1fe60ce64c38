"""Thin-lens camera rays and the interactive app's fly-cam (port of
``raytracingpbr_tpu/ops/camera.py``)."""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import rng as rnglib
from ..core.device import resolve
from ..core.math import normalize, radians
from ..core.types import Camera, Rays
from ..utils.profiling import traced


@traced("camera")
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
    # divisors on the device: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, one rounding more than the CPU's
    w, h = (torch.full((), float(k), dtype=jx.dtype, device=jx.device)
            for k in (width, height))
    return torch.stack([(i + jx) / w, (j + jy) / h], dim=-1)


def vec_to_euler(front: torch.Tensor):
    """Unit direction -> (yaw, pitch), the fly-cam's convention: yaw about
    +y measured from +z, pitch = asin(y)."""
    yaw = torch.atan2(front[..., 0], front[..., 2])
    pitch = torch.asin(torch.clamp(front[..., 1], -1.0, 1.0))
    return yaw, pitch


def euler_to_vec(yaw, pitch) -> torch.Tensor:
    cp = torch.cos(pitch)
    return torch.stack([cp * torch.sin(yaw), torch.sin(pitch),
                        cp * torch.cos(yaw)], dim=-1)


def fly_rotate(position: torch.Tensor, lookat: torch.Tensor, d_yaw,
               d_pitch) -> torch.Tensor:
    """Arrow-key rotation with the gimbal clamp: turn the view direction
    by (d_yaw, d_pitch), pitch clamped to +-0.999 pi/2. Returns the new
    lookat."""
    yaw, pitch = vec_to_euler(normalize(lookat - position))
    yaw = yaw - d_yaw
    lim = math.pi * 0.5 * 0.999
    pitch = torch.clamp(pitch + d_pitch, -lim, lim)
    return position + euler_to_vec(yaw, pitch)


@dataclasses.dataclass
class SmoothCameraState:
    """The damped camera: it moves toward a target at ``velocity`` (1/s;
    10 in the reference) and reports ``moving``, which refreshes the
    accumulation."""

    position: torch.Tensor  # (3,)
    lookat: torch.Tensor    # (3,)
    up: torch.Tensor        # (3,)
    velocity: torch.Tensor  # ()
    moving: torch.Tensor    # () bool

    def replace(self, **kw) -> "SmoothCameraState":
        return dataclasses.replace(self, **kw)


def make_smooth_camera(position, lookat, up=(0.0, 1.0, 0.0),
                       velocity=10.0, dtype=torch.float32,
                       device=None) -> SmoothCameraState:
    device = resolve(device)
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return SmoothCameraState(f(position), f(lookat), f(up), f(velocity),
                             torch.tensor(False, device=device))


def smooth_update(state: SmoothCameraState, dt, target_position,
                  target_lookat, target_up) -> SmoothCameraState:
    """One damping step: each field moves ``clamp(velocity * dt, 0, 1)`` of
    the way to its target; ``moving`` is whether any residual exceeded
    1e-3."""
    a = torch.clamp(state.velocity * dt, 0.0, 1.0)
    dp = target_position - state.position
    dl = target_lookat - state.lookat
    du = target_up - state.up
    moving = torch.maximum(
        dp.abs().max(), torch.maximum(dl.abs().max(), du.abs().max())) > 1e-3
    return state.replace(position=state.position + dp * a,
                         lookat=state.lookat + dl * a,
                         up=state.up + du * a, moving=moving)
