"""Carry the JAX package's state across to the port, and back to numpy.

The JAX objects are read by attribute and ``np.asarray``-ed, so this module
needs no jax import: it works on any object with the JAX package's field
names. Static metadata (shape types, buckets, ``rot_perm``) is copied as it
is, and tensors keep their exact values. Like every constructor of the
port, the converters build on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from . import config as cfglib
from .core.device import resolve
from .core.types import Camera, FrameState, Rays
from .ops.ibl import Environment
from .ops.scene import _BUFFERS, Scene
from .ops.sdf import BunnyMLP
from .parallel.render import local_rows, map_rows


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def _opt(x, device):
    return None if x is None else _t(x, device)


def config_from_jax(cfg) -> cfglib.RenderConfig:
    """A JAX ``RenderConfig`` -> the port's, field by field (enums by
    value)."""
    kw = {}
    for f in dataclasses.fields(cfglib.RenderConfig):
        v = getattr(cfg, f.name)
        if isinstance(f.default, enum.Enum):
            v = type(f.default)(v.value)
        kw[f.name] = v
    return cfglib.RenderConfig(**kw)


def scene_from_jax(scene, device=None) -> Scene:
    device = resolve(device)
    jb = getattr(scene, "bunny", None)
    bunny = None if jb is None else BunnyMLP(
        *(_t(getattr(jb, k), device) for k in BunnyMLP._fields))
    return Scene(scene.shape_types, scene.type_splits, scene.bucket_types,
                 scene.box_round, scene.rot_perm, bunny=bunny,
                 **{k: _t(getattr(scene, k), device) for k in _BUFFERS})


def scene_to_numpy(scene: Scene) -> dict:
    """The port's scene's float buffers as numpy arrays, by the JAX
    ``Scene``'s field names (``jax_scene.replace(**...)`` carries a
    trained scene back)."""
    return {k: getattr(scene, k).detach().cpu().numpy() for k in _BUFFERS}


def camera_from_jax(cam, device=None) -> Camera:
    device = resolve(device)
    return Camera(*(_t(getattr(cam, f.name), device)
                    for f in dataclasses.fields(Camera)))


def environment_from_jax(env, device=None) -> Environment:
    device = resolve(device)
    return Environment(kind=str(env.kind), bilinear=bool(env.bilinear),
                       image=_opt(env.image, device),
                       scale=_t(env.scale, device),
                       color_a=_opt(env.color_a, device),
                       color_b=_opt(env.color_b, device),
                       s_prob=_opt(env.s_prob, device),
                       s_alias=_opt(env.s_alias, device),
                       s_pdf=_opt(env.s_pdf, device))


def rays_from_jax(rays, device=None) -> Rays:
    device = resolve(device)
    return Rays(_t(rays.origin, device), _t(rays.direction, device),
                _t(rays.color, device), _t(rays.depth, device, torch.int32))


def frame_state_from_jax(state, device=None, mesh=None) -> FrameState:
    """A JAX ``FrameState`` -> the port's. ``frame`` and the uint32
    ``respawn`` counter become int64.

    With a ``mesh`` (``parallel/mesh.Mesh``), ``state`` is one the JAX
    package keeps sharded over a mesh of as many tiles (its pixel-major
    leaves in (tile, slot) order, as ``render_frame_sharded`` leaves them)
    and the result is this process's rows of it. A JAX state in image
    order goes to the port's rows through
    ``parallel/render.shard_frame_state`` (``shard_pixels``) instead."""
    if mesh is not None:
        return map_rows(frame_state_from_jax(state, device),
                        lambda x: local_rows(x, mesh))
    device = resolve(device)
    return FrameState(
        rays=rays_from_jax(state.rays, device),
        accum=_t(state.accum, device),
        frame=_t(state.frame, device, torch.int64),
        diff_accum=_t(state.diff_accum, device),
        noise=_t(state.noise, device),
        pixels=_t(state.pixels, device),
        respawn=_t(np.asarray(state.respawn).astype(np.int64), device),
        hit_t=_t(state.hit_t, device),
        sky_w=_t(state.sky_w, device),
        march_state=_t(state.march_state, device),
        march_cum=_t(state.march_cum, device, torch.int32),
    )


def frame_state_to_numpy(state: FrameState) -> dict:
    """The port's state as a flat dict of numpy arrays in the JAX package's
    dtypes (``rays.*`` keys for the rays; ``frame`` int32, ``respawn``
    uint32)."""
    out = {f"rays.{f.name}": getattr(state.rays, f.name).cpu().numpy()
           for f in dataclasses.fields(Rays)}
    for f in dataclasses.fields(FrameState):
        if f.name != "rays":
            out[f.name] = getattr(state, f.name).cpu().numpy()
    out["frame"] = out["frame"].astype(np.int32)
    out["respawn"] = out["respawn"].astype(np.uint32)
    return out
