"""Temporal reprojection of the progressive accumulator (port of
``raytracingpbr_tpu/ops/reproject.py``).

When the camera moves, the reference zeroes the accumulator and starts
again from one sample a pixel. Here the old accumulation is warped
forward into the new view instead:

1. each pixel's primary surface point from the OLD camera's pixel-center
   ray and the primary-hit depth the wavefront records
   (``FrameState.hit_t``);
2. projected through the NEW camera (the pinhole inverse of
   ``ops/camera.get_ray``);
3. the (rgb sum, count) history added into the target pixels
   (``index_add_``), its count clamped to ``cfg.reproject_history_cap``
   and scaled by ``cfg.reproject_confidence``; the warped depths kept by
   their minimum (``scatter_reduce_(..., "amin")``).

Determinism: on the CPU ``index_add_`` adds the sources of a target in
lane order, as JAX's scatter does there. On the card it adds them with
atomics, so where several sources land on one pixel the order of the f32
adds, and the last bits of that pixel's sum, can change from run to run.
The minimum is exact in any order.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from ..core.math import dot, radians
from ..core.types import NO_HIT_T, Camera, FrameState, refresh


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded once to ``x``'s type from float64: PyTorch's
    float32 square roots on the card and on the CPU part in the last bit
    on about one input in a hundred, and ``reproject``'s depths are held to
    the CPU's bits."""
    return torch.sqrt(x.double()).to(x.dtype)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """``v`` over its length, the squares summed in a fixed order (the
    card's ``linalg.vector_norm`` adds them in another) and the root by
    :func:`_sqrt`."""
    return v / _sqrt(dot(v, v))[..., None]


def camera_basis(cam: Camera):
    """The look-at basis of ``ops/camera.get_ray``: (x, y, z) rows."""
    z = _unit(cam.lookfrom - cam.lookat)
    x = _unit(torch.linalg.cross(cam.vup, z))
    y = torch.linalg.cross(z, x)
    return x, y, z


def _half_extent(cam: Camera):
    half_height = torch.tan(radians(cam.vfov) * 0.5)
    return cam.aspect * half_height, half_height


def pixel_center_rays(cam: Camera, cfg: RenderConfig):
    """Pinhole (aperture 0) rays through every pixel center, the
    deterministic stand-in for the jittered primaries whose depths were
    recorded. Returns (origin (3,), directions (N, 3))."""
    half_width, half_height = _half_extent(cam)
    x, y, z = camera_basis(cam)
    dev, dtype = cam.lookfrom.device, cam.lookfrom.dtype
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    # divisors on the device: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, one rounding more than the CPU's
    width, height = (torch.full((), float(k), dtype=dtype, device=dev)
                     for k in (cfg.width, cfg.height))
    u = ((pid // cfg.height).to(dtype) + 0.5) / width
    v = ((pid % cfg.height).to(dtype) + 0.5) / height
    d = ((2.0 * u - 1.0)[:, None] * (half_width * x)
         + (2.0 * v - 1.0)[:, None] * (half_height * y) - z)
    return cam.lookfrom, _unit(d)


def project(cam: Camera, cfg: RenderConfig, points: torch.Tensor):
    """World points (N, 3) -> (flat pixel index (N,) int64, valid (N,))
    under ``cam``: the inverse of the film-plane mapping of
    ``ops/camera.get_ray`` (aperture 0).

    The pixel's bounds are tested on the floored floats, before any
    conversion to an integer: a point behind the camera, off the frustum
    or not finite is invalid on every lane, whatever an out-of-range
    float-to-int conversion would give on the device. An invalid lane's
    index is a clamped pixel that it adds nothing to."""
    half_width, half_height = _half_extent(cam)
    x, y, z = camera_basis(cam)
    d = points - cam.lookfrom
    dx, dy, dz = dot(d, x), dot(d, y), dot(d, z)
    in_front = dz < -1e-6
    denom = torch.where(in_front, -dz, torch.ones_like(dz))
    u = (dx / denom / half_width + 1.0) * 0.5
    v = (dy / denom / half_height + 1.0) * 0.5
    fi = torch.floor(u * cfg.width)
    fj = torch.floor(v * cfg.height)
    valid = (in_front & (fi >= 0) & (fi < cfg.width)
             & (fj >= 0) & (fj < cfg.height))
    zero = torch.zeros_like(fi)
    i = torch.where(valid, fi, zero).to(torch.int64)
    j = torch.where(valid, fj, zero).to(torch.int64)
    return i * cfg.height + j, valid


def reproject(state: FrameState, old_cam: Camera, new_cam: Camera,
              cfg: RenderConfig) -> FrameState:
    """Warp ``state``'s accumulator from ``old_cam``'s view into
    ``new_cam``'s and re-arm the wavefront: the replacement for
    ``refresh()`` when the camera moved."""
    ro, rd = pixel_center_rays(old_cam, cfg)
    # sky and miss history rides at the far plane: its parallax under a
    # translation is negligible, and a rotation moves it exactly
    t = torch.clamp_max(state.hit_t, cfg.max_dis)
    points = ro + t[:, None] * rd

    target, valid = project(new_cam, cfg, points)
    count = state.accum[:, 3]
    valid = valid & (count > 0.0)

    # clamp the history's weight and scale it by the confidence
    scale = torch.where(count > 0.0,
                        torch.clamp_max(count, cfg.reproject_history_cap)
                        / torch.clamp_min(count, 1e-8),
                        torch.zeros_like(count))
    scale = scale * cfg.reproject_confidence * valid.to(count.dtype)
    history = state.accum * scale[:, None]
    accum = torch.zeros_like(state.accum).index_add_(0, target, history)

    # the warped depths seed the NEXT reprojection until the first fresh
    # primaries overwrite them, as distances along the NEW camera's rays
    # (unit directions: ray t is the metric distance)
    off = points - new_cam.lookfrom
    t_new = _sqrt(dot(off, off))
    hit_t = torch.full_like(state.hit_t, NO_HIT_T).scatter_reduce_(
        0, target, torch.where(valid, t_new, torch.full_like(t_new,
                                                             NO_HIT_T)),
        "amin")
    return refresh(state).replace(accum=accum, hit_t=hit_t)
