"""Ray, camera and frame-state types (port of
``raytracingpbr_tpu/core/types.py``).

Each type is a dataclass of tensors in struct-of-arrays layout: a batch of
rays is one ``Rays`` whose members are ``(N, 3)`` / ``(N,)``. Makers build
on the card unless given ``device="cpu"`` (``core/device.resolve``).

Integer widths: ``depth`` and ``march_cum`` are int32 as in JAX. The JAX
package's uint32 ``respawn`` counter is int64 here (PyTorch's uint32
arithmetic is incomplete); the RNG masks it to 32 bits.
"""
from __future__ import annotations

import dataclasses

import torch

from .device import resolve

# FrameState.hit_t sentinel: no surface recorded for this pixel yet
NO_HIT_T = 1e10


@dataclasses.dataclass
class Rays:
    """Wavefront ray state. ``depth`` > 0: alive at that bounce depth;
    <= 0: terminated, awaiting respawn."""

    origin: torch.Tensor     # (N, 3) f32
    direction: torch.Tensor  # (N, 3) f32
    color: torch.Tensor      # (N, 3) f32 path throughput
    depth: torch.Tensor      # (N,) i32


def make_rays(n: int, device=None, dtype=torch.float32) -> Rays:
    device = resolve(device)
    z3 = lambda: torch.zeros((n, 3), dtype=dtype, device=device)
    return Rays(z3(), z3(), z3(),
                torch.zeros((n,), dtype=torch.int32, device=device))


@dataclasses.dataclass
class Camera:
    """Thin-lens camera; scalar fields are 0-d tensors."""

    lookfrom: torch.Tensor  # (3,)
    lookat: torch.Tensor    # (3,)
    vup: torch.Tensor       # (3,)
    vfov: torch.Tensor      # () degrees
    aspect: torch.Tensor    # ()
    aperture: torch.Tensor  # ()
    focus: torch.Tensor     # ()


def make_camera(lookfrom=(0.0, -0.2, 4.0), lookat=(0.0, -0.2, 3.0),
                vup=(0.0, 1.0, 0.0), vfov=35.0, aspect=16.0 / 9.0,
                aperture=0.01, focus=4.0, device=None,
                dtype=torch.float32) -> Camera:
    device = resolve(device)
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return Camera(f(lookfrom), f(lookat), f(vup), f(vfov), f(aspect),
                  f(aperture), f(focus))


@dataclasses.dataclass
class FrameState:
    """Persistent per-pixel state of the progressive wavefront.

    ``accum`` (N, 4): rgb sum and completed-sample count. ``frame``: 0-d
    int64 frame counter (never reset by :func:`refresh`). ``diff_accum`` /
    ``noise``: adaptive-sampling noise estimate. ``pixels``: last tonemapped
    output. ``respawn``: per-pixel camera-sample counter. ``hit_t``:
    primary-hit depth. ``sky_w``: sky-lookup weight (env sampling).
    ``march_state`` (N, 4) / ``march_cum`` (N,): the split-march carry —
    packed (t, w, s, d) of an in-flight segment and the trips it has
    consumed (0 = none in flight).
    """

    rays: Rays
    accum: torch.Tensor        # (N, 4)
    frame: torch.Tensor        # () i64
    diff_accum: torch.Tensor   # (N, 2)
    noise: torch.Tensor        # (N,)
    pixels: torch.Tensor       # (N, 3)
    respawn: torch.Tensor      # (N,) i64
    hit_t: torch.Tensor        # (N,)
    sky_w: torch.Tensor        # (N,)
    march_state: torch.Tensor  # (N, 4)
    march_cum: torch.Tensor    # (N,) i32

    def replace(self, **kw) -> "FrameState":
        return dataclasses.replace(self, **kw)


def make_frame_state(n: int, device=None,
                     dtype=torch.float32) -> FrameState:
    """Fresh state (the reference's ``refresh()``)."""
    device = resolve(device)
    kw = dict(dtype=dtype, device=device)
    return FrameState(
        rays=make_rays(n, device, dtype),
        accum=torch.zeros((n, 4), **kw),
        frame=torch.zeros((), dtype=torch.int64, device=device),
        diff_accum=torch.ones((n, 2), **kw),
        noise=torch.full((n,), 1e32, **kw),
        pixels=torch.zeros((n, 3), **kw),
        respawn=torch.zeros((n,), dtype=torch.int64, device=device),
        hit_t=torch.full((n,), NO_HIT_T, **kw),
        sky_w=torch.ones((n,), **kw),
        march_state=torch.zeros((n, 4), **kw),
        march_cum=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def refresh(state: FrameState) -> FrameState:
    """Reset accumulation after camera motion: zero the accumulator, re-arm
    the wavefront (depth 0 respawns next step) and the adaptive buffers,
    and drop any in-flight march segment."""
    return state.replace(
        rays=dataclasses.replace(state.rays,
                                 depth=torch.zeros_like(state.rays.depth)),
        accum=torch.zeros_like(state.accum),
        diff_accum=torch.ones_like(state.diff_accum),
        noise=torch.full_like(state.noise, 1e32),
        respawn=torch.zeros_like(state.respawn),
        hit_t=torch.full_like(state.hit_t, NO_HIT_T),
        sky_w=torch.ones_like(state.sky_w),
        march_state=torch.zeros_like(state.march_state),
        march_cum=torch.zeros_like(state.march_cum),
    )
