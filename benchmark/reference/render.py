"""The reference's renderer: the counter RNG, the thin-lens camera, the
stochastic surface interaction, the sky, the tonemap, the progressive
wavefront frame (depth-linear roulette, the split march carried across
steps, the deposit and respawn) and the differentiable megakernel with the
pixel-loss forward (a frozen copy of the program's plain ``core/rng.py``,
``ops/camera.py``, ``ops/shade.py``, ``ops/ibl.py``, ``ops/post.py``,
``ops/integrator.py`` and ``parallel/train.render_pixels``, the paths the
benchmark's configurations take: no NEE, adaptive sampling,
reprojection, low-discrepancy sampling or replay). The sky is a part,
``sky/<kind>.py``; a path beyond these is a feature,
``features/<name>.py``, that replaces a stage (``reference.BASE``).

The render settings are a dict ``rc`` of the configuration file's
``render`` fields plus ``seed``, ``pixel_radius`` and ``min_dis``
(:func:`settings`). A frame state is a dict of tensors (:func:`fresh_state`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import base, part, stage
from . import scene as sc
from .march import march_full

MASK = 0xFFFFFFFF
_PCG_MULT = 1664525
_PCG_INC = 1013904223
_INV_2_24 = 1.0 / (1 << 24)
# RNG streams: roulette, camera, shading
S_ROULETTE, S_CAMERA, S_SHADE = 0, 1, 2
NO_HIT_T = 1e10
_LUMA = (0.299, 0.587, 0.114)
ACES_INPUT = ((0.59719, 0.35458, 0.04823),
              (0.07600, 0.90834, 0.01566),
              (0.02840, 0.13383, 0.83777))
ACES_OUTPUT = ((1.60475, -0.53108, -0.07367),
               (-0.10208, 1.10813, -0.00605),
               (-0.00327, -0.07276, 1.07602))
# render settings beyond the plain path: one that a configuration turns on
# is refused unless the configuration lists a feature of its name
OPTIONAL = ("adaptive_sampling", "env_sampling", "escape_bound",
            "low_discrepancy", "reprojection", "march_compaction",
            "bunny_mxu")


def settings(render: dict, seed: int, features=()) -> dict:
    """The render settings of a configuration's ``render`` dict, with the
    seed, the derived pixel radius and restart offset, and ``features``,
    the configuration's ``reference_features`` (each a module
    ``features/<name>.py``)."""
    on = [k for k in OPTIONAL if render.get(k) and k not in features]
    if on:
        raise ValueError(f"the reference does not render {on} unless the "
                         f"configuration lists them in reference_features")
    for f in features:
        part("features", f)
    rc = dict(render)
    rc["features"] = tuple(features)
    w, h = rc["resolution"]
    rc["seed"] = int(seed) & MASK
    rc["pixel_radius"] = min(1.0 / w, 1.0 / h)
    rc["min_dis"] = 2.5 * rc["pixel_radius"]
    rc["num_pixels"] = w * h
    return rc


# --- RNG ---------------------------------------------------------------------


def _u32(x, like):
    if isinstance(x, int):
        return torch.full(like.shape, x & MASK, dtype=torch.int64,
                          device=like.device)
    x = torch.as_tensor(x, device=like.device)
    return torch.broadcast_to(x.to(torch.int64) & MASK, like.shape)


def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(x, y, z, w):
    x, y, z, w = x & MASK, y & MASK, z & MASK, w & MASK
    x = (_mul32(x, _PCG_MULT) + _PCG_INC) & MASK
    y = (_mul32(y, _PCG_MULT) + _PCG_INC) & MASK
    z = (_mul32(z, _PCG_MULT) + _PCG_INC) & MASK
    w = (_mul32(w, _PCG_MULT) + _PCG_INC) & MASK
    x = (x + _mul32(y, w)) & MASK
    y = (y + _mul32(z, x)) & MASK
    z = (z + _mul32(x, y)) & MASK
    w = (w + _mul32(y, z)) & MASK
    x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
    x = (x + _mul32(y, w)) & MASK
    y = (y + _mul32(z, x)) & MASK
    z = (z + _mul32(x, y)) & MASK
    w = (w + _mul32(y, z)) & MASK
    return x, y, z, w


def uniform4(pixel_id, step, stream: int, seed: int, dtype):
    words = pcg4d(_u32(pixel_id, pixel_id), _u32(step, pixel_id),
                  _u32(stream, pixel_id), _u32(seed, pixel_id))
    return tuple((v >> 8).to(dtype) * _INV_2_24 for v in words)


def _in_unit_disk(u1, u2):
    a = u2 * (2.0 * math.pi)
    r = torch.sqrt(u1)
    return torch.stack([r * torch.sin(a), r * torch.cos(a)], dim=-1)


def _in_unit_sphere(u1, u2):
    z = 2.0 * u1 - 1.0
    a = u2 * (2.0 * math.pi)
    xy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([xy * torch.sin(a), xy * torch.cos(a), z], dim=-1)


def _hemispheric(normal, u1, u2):
    s = normal + _in_unit_sphere(u1, u2)
    return s / torch.linalg.vector_norm(s, dim=-1, keepdim=True)


# --- small math --------------------------------------------------------------


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _mix(a, b, t):
    return a + (b - a) * t


def brightness(rgb):
    return (rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1]
            + rgb[..., 2] * _LUMA[2])


def _where(mask, a, b):
    return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)


# --- camera ------------------------------------------------------------------


def make_camera(cam: dict, device, dtype=torch.float32) -> dict:
    """The camera's tensors from a configuration's ``camera`` dict."""
    return {k: torch.as_tensor(cam[k], dtype=dtype, device=device)
            for k in ("lookfrom", "lookat", "vup", "vfov", "aspect",
                      "aperture", "focus")}


def pixel_uv(pixel_id, width: int, height: int, jx, jy):
    i = torch.div(pixel_id, height, rounding_mode="floor").to(jx.dtype)
    j = torch.remainder(pixel_id, height).to(jx.dtype)
    w, h = (torch.full((), float(k), dtype=jx.dtype, device=jx.device)
            for k in (width, height))
    return torch.stack([(i + jx) / w, (j + jy) / h], dim=-1)


def get_ray(cam: dict, uv, u1, u2):
    """Primary rays (origin, direction, color, depth) for film uv."""
    theta = cam["vfov"] * (math.pi / 180.0)
    half_height = torch.tan(theta * 0.5)
    half_width = cam["aspect"] * half_height
    z = _normalize(cam["lookfrom"] - cam["lookat"])
    x = _normalize(torch.linalg.cross(cam["vup"], z))
    y = torch.linalg.cross(z, x)
    lens_radius = cam["aperture"] * 0.5
    rud = lens_radius * _in_unit_disk(u1, u2)
    offset = rud[:, :1] * x + rud[:, 1:2] * y
    hwfx = half_width * cam["focus"] * x
    hhfy = half_height * cam["focus"] * y
    lower_left = cam["lookfrom"] - hwfx - hhfy - cam["focus"] * z
    ro = cam["lookfrom"] + offset
    po = lower_left + uv[:, :1] * 2.0 * hwfx + uv[:, 1:2] * 2.0 * hhfy
    rd = _normalize(po - ro)
    n = uv.shape[0]
    return (ro, rd, torch.ones((n, 3), dtype=uv.dtype, device=uv.device),
            torch.zeros((n,), dtype=torch.int32, device=uv.device))


# --- sky ---------------------------------------------------------------------


def sky_image(sky: dict) -> Optional[np.ndarray]:
    """The raw (W, H, 3) image of a configuration's ``sky`` dict (None
    where the kind has none): ``sky/<kind>.py``'s ``image``."""
    return part("sky", sky["kind"]).image(sky)


def make_sky(sky: dict, image: Optional[np.ndarray], device,
             dtype=torch.float32) -> dict:
    """The sky as the renderer reads it, baked on the device."""
    return part("sky", sky["kind"]).bake(sky, image, device, dtype)


def sky_color(sky: dict, direction):
    return part("sky", sky["kind"]).color(sky, direction)


# --- shading -----------------------------------------------------------------


def _schlick(no_i, f0):
    return _mix(torch.abs(1.0 + no_i) ** 5, 1.0, f0)


@base("interaction")
def interaction(scene, index, position, direction, u, rc: dict,
                roughness_fresnel: bool = False,
                restart_at_hit: bool = False,
                reflect_kill: Optional[bool] = None):
    """The stochastic interaction at a hit. Returns (direction, origin,
    color_scale, normal)."""
    if reflect_kill is None:
        reflect_kill = roughness_fresnel
    albedo, _, roughness, metallic, transmission, ior = sc.materials_at(
        scene, index)
    normal = sc.calc_normal(scene, index, position)
    outer = sc.dot(direction, normal) < 0.0
    normal = torch.where(outer[:, None], normal, -normal)
    alpha = (roughness * roughness)[:, None]
    hemi = _hemispheric(normal, u[0], u[1])
    rough_n = _normalize(_mix(normal, hemi, alpha))
    i = direction
    no_i = sc.dot(rough_n, i)
    env_ior = rc["env_ior"]
    eta = torch.where(outer, env_ior / ior, ior / env_ior)
    k = 1.0 - eta * eta * (1.0 - no_i * no_i)
    f0 = 2.0 * (eta - 1.0) / (eta + 1.0)
    f0 = f0 * f0
    if roughness_fresnel and rc["f0_half"]:
        f0 = 0.5 * f0
    fr = _schlick(no_i, f0)
    if roughness_fresnel:
        fr = _mix(fr, f0, roughness)
    refl = i - 2.0 * no_i[:, None] * rough_n
    refl_outer = sc.dot(refl, normal) < 0.0
    if not reflect_kill:
        refl = torch.where(refl_outer[:, None], -refl, refl)
    k_safe = torch.clamp_min(k, 1e-12)
    refr = eta[:, None] * i - (torch.sqrt(k_safe) + eta * no_i)[:, None] \
        * rough_n
    take_reflect = (u[2] < fr + metallic) | (k < 0.0)
    take_refract = (~take_reflect) & (u[3] < transmission)
    new_dir = torch.where(take_reflect[:, None], refl,
                          torch.where(take_refract[:, None], refr, hemi))
    color_scale = albedo
    if reflect_kill:
        killed = take_reflect & refl_outer
        color_scale = color_scale * (~killed).to(albedo.dtype)[:, None]
    if restart_at_hit:
        new_origin = position
    else:
        leave_outer = sc.dot(new_dir, normal) < 0.0
        offs = torch.where(leave_outer, -rc["min_dis"], rc["min_dis"])
        new_origin = position + normal * offs[:, None]
    return new_dir, new_origin, color_scale, normal


# --- tonemap -----------------------------------------------------------------


def _mat3(m, rgb):
    c = [rgb[..., k] for k in range(3)]
    return torch.stack([m[i][0] * c[0] + m[i][1] * c[1] + m[i][2] * c[2]
                        for i in range(3)], dim=-1)


def _aces(rgb):
    v = _mat3(ACES_INPUT, rgb)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return _mat3(ACES_OUTPUT, a / b)


def tonemap_accum(accum, rc: dict):
    """The displayed pixels of an accumulator (N, 4): the mean, then the
    configured tonemap and the clamp."""
    count = accum[..., 3:4]
    mean = accum[..., :3] / torch.clamp_min(count, 1e-12)
    rgb = torch.where(count > 0, mean, torch.zeros_like(mean))
    inv_gamma = 1.0 / rc["gamma"]
    exposure = 1.0
    if rc["tonemap"] == "gamma_then_aces":
        out = _aces((rgb * exposure) ** inv_gamma)
    elif rc["tonemap"] == "aces_then_gamma":
        out = torch.clamp_min(_aces(rgb * exposure), 0.0) ** inv_gamma
    else:
        out = rgb * exposure
    if rc["clamp_output"]:
        out = torch.clamp(out, 0.0, 1.0)
    return out


# --- the progressive wavefront -----------------------------------------------

STATE_FIELDS = ("origin", "direction", "color", "depth", "accum", "pixels",
                "respawn", "hit_t", "march_state", "march_cum")


def fresh_state(n: int, device, dtype=torch.float32) -> dict:
    """A fresh frame state of ``n`` pixels (``frame`` is kept apart)."""
    kw = dict(dtype=dtype, device=device)
    return {"origin": torch.zeros((n, 3), **kw),
            "direction": torch.zeros((n, 3), **kw),
            "color": torch.zeros((n, 3), **kw),
            "depth": torch.zeros((n,), dtype=torch.int32, device=device),
            "accum": torch.zeros((n, 4), **kw),
            "pixels": torch.zeros((n, 3), **kw),
            "respawn": torch.zeros((n,), dtype=torch.int64, device=device),
            "hit_t": torch.full((n,), NO_HIT_T, **kw),
            "march_state": torch.zeros((n, 4), **kw),
            "march_cum": torch.zeros((n,), dtype=torch.int32,
                                     device=device)}


@base("bounce")
def bounce(scene, sky, o, d, color, depth, pixel_id, step, rc, mstate,
           mcum, chains):
    """One bounce under the split march: returns the traced rays, the
    march's t and hit, the lanes whose segment completed, and the carry."""
    marching = mcum > 0
    defaults = (rc["march_t0"], rc["omega"], 0.0, sc.MAX_DIS)
    init = tuple(torch.where(marching, mstate[:, k],
                             torch.full_like(mstate[:, k], v))
                 for k, v in enumerate(defaults))
    rr = stage(rc, "march")(scene, o, d, rc, rc["march_split"], init=init,
                            chains=chains)
    cum_new = mcum + rr.fin
    completed = torch.ones_like(marching) & (
        (rr.done > 0) | (cum_new >= rc["max_raymarch"]))
    t, index, hit = rr.t, rr.index, rr.hit
    resume = (_where(completed, torch.zeros_like(mstate),
                     torch.stack([rr.t, rr.w, rr.s, rr.d], dim=-1)),
              torch.where(completed, 0, cum_new).to(mcum.dtype))
    position = o + t[:, None] * d
    depth1 = depth + 1
    u4 = uniform4(pixel_id, step, S_SHADE, rc["seed"], color.dtype)
    new_dir, new_origin, color_scale, _ = stage(rc, "interaction")(
        scene, index, position, d, u4, rc)
    color_hit = color * color_scale
    intensity = brightness(color_hit)
    color_hit = color_hit * sc.materials_at(scene, index)[1]
    visible = brightness(color_hit)
    vis = rc["visibility"]
    stop = (intensity < visible) | (visible < vis[0]) | (visible > vis[1])
    depth_hit = torch.where(stop, -depth1, depth1)
    color_miss = color * sky_color(sky, d)
    depth_miss = -depth1
    if rc["black_background"]:
        color_miss = color_miss * (depth_miss < -1).to(color_miss.dtype)[
            :, None]
    traced = (_where(hit, new_origin, position), _where(hit, new_dir, d),
              _where(hit, color_hit, color_miss),
              torch.where(hit, depth_hit, depth_miss))
    traced = tuple(_where(completed, a, b)
                   for a, b in zip(traced, (o, d, color, depth)))
    return traced, t, hit, completed, resume


@base("wavefront_step")
def wavefront_step(scene, sky, cam, st: dict, pixel_id, step, rc: dict,
                   chains: bool = True) -> dict:
    """One roulette step of every pixel in ``st`` (a state dict; returns
    the next)."""
    o, d, color, depth = st["origin"], st["direction"], st["color"], \
        st["depth"]
    mstate, mcum = st["march_state"], st["march_cum"]
    dtype = color.dtype
    split = (rc["march_split"] is not None
             and rc["max_raymarch"] > rc["march_split"]
             and rc["max_raymarch"] % rc["march_split"] == 0)
    if not split:
        raise ValueError("the reference's wavefront runs the split march")
    marching = mcum > 0
    u_r = uniform4(pixel_id, step, S_ROULETTE, rc["seed"], dtype)[0]
    prob = torch.where(depth == 0, 1.0,
                       rc["quality_per_sample"]
                       - depth.to(dtype) * (1.0 / rc["max_raytrace"]))
    kill = (u_r > prob) & ~marching
    survive = ~kill
    color_surv = color / torch.clamp_min(prob, 1e-8)[:, None]
    color_surv = _where(marching, color, color_surv)
    finished = ((depth < 1) | (depth > rc["max_raytrace"])) & ~marching
    deposit = finished & survive
    sample = torch.cat([color_surv, torch.ones_like(u_r)[:, None]], -1)
    accum = st["accum"] + _where(deposit, sample, torch.zeros_like(sample))
    u_cam = uniform4(pixel_id, step, S_CAMERA, rc["seed"], dtype)
    w, h = rc["resolution"]
    uv = pixel_uv(pixel_id, w, h, u_cam[0], u_cam[1])
    f_o, f_d, f_c, _ = get_ray(cam, uv, u_cam[2], u_cam[3])
    pre = (_where(finished, f_o, o), _where(finished, f_d, d),
           _where(finished, f_c, color_surv),
           torch.where(finished, 0, depth))
    traced, march_t, march_hit, completed, (ms_new, mc_new) = stage(
        rc, "bounce")(scene, sky, *pre, pixel_id, step, rc, mstate, mcum,
                      chains)
    new = {"origin": _where(survive, traced[0], o),
           "direction": _where(survive, traced[1], d),
           "color": _where(survive, traced[2], torch.zeros_like(color)),
           "depth": torch.where(survive, traced[3], -depth)}
    used = finished & survive
    new["respawn"] = st["respawn"] + used.to(st["respawn"].dtype)
    rec = completed & (pre[3] == 0) & survive
    new["hit_t"] = torch.where(rec, torch.where(march_hit, march_t,
                                                NO_HIT_T), st["hit_t"])
    new["march_cum"] = torch.where(survive, mc_new, 0).to(mcum.dtype)
    new["march_state"] = ms_new
    new["accum"] = accum
    new["pixels"] = st["pixels"]
    return new


def render_frame(scene, sky, cam, st: dict, frame: int, pixel_id, rc: dict,
                 chains: bool = True) -> dict:
    """One displayed frame of the pixels ``pixel_id`` (the stage
    ``render_frame``)."""
    return stage(rc, "render_frame")(scene, sky, cam, st, frame, pixel_id,
                                     rc, chains)


@base("render_frame")
def _render_frame(scene, sky, cam, st: dict, frame: int, pixel_id,
                  rc: dict, chains: bool = True) -> dict:
    """The frame's steps (counters ``frame * steps + k``), then the tonemap
    into ``pixels``."""
    steps = rc["samples_per_frame"] * rc["samples_per_pixel"]
    step = stage(rc, "wavefront_step")
    for k in range(steps):
        st = step(scene, sky, cam, st, pixel_id, frame * steps + k, rc,
                  chains)
    st = dict(st)
    st["pixels"] = tonemap_accum(st["accum"], rc)
    return st


# --- the differentiable megakernel and the pixel loss ------------------------


@base("megakernel_trace")
def megakernel_trace(scene, sky, rays, pixel_id, sample_idx: int, rc: dict,
                     chains: bool = True):
    """Scan-AD through every bounce of a batch of paths (EXP roulette
    where configured; the full march, attached at each hit; the
    interaction with the roughness-remapped Fresnel, restarting at the
    hit, a below-surface reflection folded back; the sky on a miss).
    Returns the (N, 3) radiance."""
    origin, direction, color, _ = rays
    dtype = color.dtype
    max_bounce = rc["max_raytrace"]
    base = (int(sample_idx) & MASK) * max_bounce
    alive = torch.ones(origin.shape[:1], dtype=torch.bool,
                       device=origin.device)
    vis = rc["visibility"]
    i = 0
    while i < max_bounce:
        counter = (base + i) & MASK
        if rc["roulette"] == "exp":
            inv_pdf = torch.exp(torch.tensor(i, dtype=torch.float32)
                                / rc["light_quality"])
            roulette_prob = float(1.0 - 1.0 / inv_pdf)
            u = uniform4(pixel_id, counter, S_ROULETTE, rc["seed"], dtype)[0]
            die = u < roulette_prob
            color = torch.where((alive & die)[:, None],
                                color * roulette_prob, color)
            alive = alive & ~die
        t, position, index, hit = march_full(
            scene, origin, direction, rc, active=alive, chains=chains)
        u4 = uniform4(pixel_id, counter, S_SHADE, rc["seed"], dtype)
        emission = sc.materials_at(scene, index)[1]
        new_dir, new_origin, color_scale, _ = stage(rc, "interaction")(
            scene, index, position, direction, u4, rc,
            roughness_fresnel=True, restart_at_hit=True, reflect_kill=False)
        color_hit = color * color_scale
        intensity = brightness(color_hit)
        color_hit = color_hit * emission
        visible = brightness(color_hit)
        stop_hit = ((intensity < visible) | (visible < vis[0])
                    | (visible > vis[1]))
        color_miss = color * sky_color(sky, direction)
        on = alive & hit
        color = _where(on, color_hit, _where(alive & ~hit, color_miss,
                                             color))
        origin = _where(on, new_origin, origin)
        direction = _where(on, new_dir, direction)
        alive = on & ~stop_hit
        i += 1
        if not bool(alive.any()):
            break
    return color


def render_pixels(scene, sky, cam, pixel_id, rc: dict, spp: int,
                  sample_offset: int, chains: bool = True):
    """The differentiable mean of ``spp`` samples of each pixel (the stage
    ``render_pixels``)."""
    return stage(rc, "render_pixels")(scene, sky, cam, pixel_id, rc, spp,
                                      sample_offset, chains)


@base("render_pixels")
def _render_pixels(scene, sky, cam, pixel_id, rc: dict, spp: int,
                   sample_offset: int, chains: bool = True):
    """The mean of ``spp`` megakernel samples, sample ids
    ``sample_offset + k``."""
    dtype = cam["lookfrom"].dtype
    acc = torch.zeros((pixel_id.shape[0], 3), dtype=dtype,
                      device=pixel_id.device)
    w, h = rc["resolution"]
    for k in range(spp):
        s = (sample_offset + k) & MASK
        u_cam = uniform4(pixel_id, s, S_CAMERA, rc["seed"], dtype)
        uv = pixel_uv(pixel_id, w, h, u_cam[0], u_cam[1])
        rays = get_ray(cam, uv, u_cam[2], u_cam[3])
        acc = acc + stage(rc, "megakernel_trace")(scene, sky, rays,
                                                  pixel_id, s, rc, chains)
    return acc / spp
