"""Progressive wavefront integrator (port of the wavefront half of
``raytracingpbr_tpu/ops/integrator.py``).

Each ``wavefront_step`` advances every pixel's path by one bounce segment:
depth-linear roulette, deposit of finished paths, thin-lens respawn, then
one march + surface interaction. With ``cfg.march_split`` the march runs at
most that many trips per step and unfinished lanes carry their exact loop
state in ``FrameState.march_state`` / ``march_cum``.

Every random draw is counter-derived from ``(pixel_id, step, stream,
seed)``. Not ported yet (raise NotImplementedError): environment sampling
(NEE/MIS), gradients and temporal reprojection; the megakernel integrator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import RenderConfig
from ..core import rng as rnglib
from ..core.math import brightness
from ..core.types import (NO_HIT_T, Camera, FrameState, Rays,
                          make_frame_state, refresh)
from . import camera as cameralib
from . import march as marchlib
from . import post as postlib
from . import scene as scenelib
from . import shade as shadelib
from .ibl import Environment, sky_color
from .scene import Scene

# RNG stream ids (use-sites within one step)
_S_ROULETTE = 0
_S_CAMERA = 1   # jitter x/y + lens u/v
_S_SHADE = 2    # hemisphere u/v + lobe u/v


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)


def _where_rays(mask: torch.Tensor, a: Rays, b: Rays) -> Rays:
    return Rays(*(_where(mask, getattr(a, f.name), getattr(b, f.name))
                  for f in dataclasses.fields(Rays)))


def _check_supported(cfg: RenderConfig, differentiable: bool = False):
    if cfg.env_sampling:
        raise NotImplementedError("environment sampling (NEE/MIS) is not "
                                  "ported yet")
    if differentiable:
        raise NotImplementedError("differentiable rendering is not ported "
                                  "yet")
    if cfg.reprojection:
        raise NotImplementedError("temporal reprojection is not ported yet")


def _trace_one_bounce(scene: Scene, env: Environment, rays: Rays,
                      pixel_id: torch.Tensor, counter, cfg: RenderConfig,
                      active: Optional[torch.Tensor] = None, resume=None):
    """One bounce: march, surface interaction or sky, emission, brightness
    termination.

    ``resume``: the split-march carry ``(march_state (N,4), march_cum
    (N,))``. The march then runs at most ``cfg.march_split`` trips; lanes
    whose segment neither hit nor escaped, and has not used up
    ``cfg.max_raymarch``, are returned unchanged in ``traced`` with their
    loop state in ``resume_out``.

    Returns ``(traced, t, hit, completed, resume_out)``; the last two are
    None without ``resume``."""
    completed = None
    resume_out = None
    if resume is not None:
        mstate, mcum = resume
        marching = mcum > 0
        mcfg = cfg.replace(max_raymarch=cfg.march_split)
        defaults = (cfg.march_t0, cfg.omega, 0.0, scenelib.MAX_DIS)
        init = tuple(torch.where(marching, mstate[:, k],
                                 torch.full_like(mstate[:, k], dflt))
                     for k, dflt in enumerate(defaults))
        rr = marchlib.march_resumable(scene, rays.origin, rays.direction,
                                      mcfg, active=active, init=init)
        act = active if active is not None else torch.ones_like(marching)
        cum_new = mcum + rr.fin
        completed = act & ((rr.done > 0) | (cum_new >= cfg.max_raymarch))
        t, index, hit = rr.t, rr.index, rr.hit
        # completed lanes re-arm next step; in-flight lanes carry the exact
        # loop state (gated-inactive lanes echo their init and pause)
        resume_out = (
            _where(completed, torch.zeros_like(mstate),
                   torch.stack([rr.t, rr.w, rr.s, rr.d], dim=-1)),
            torch.where(completed, 0, cum_new).to(mcum.dtype))
    else:
        res = marchlib.march(scene, rays.origin, rays.direction, cfg,
                             active=active)
        t, index, hit = res.t, res.index, res.hit
    position = rays.origin + t[:, None] * rays.direction
    depth = rays.depth + 1

    u4 = rnglib.uniform4(pixel_id, counter, _S_SHADE, cfg.seed,
                         rays.color.dtype)
    inter = shadelib.ray_surface_interaction(scene, index, position,
                                             rays.direction, u4, cfg)

    # hit: throughput, emission, brightness termination
    color_hit = rays.color * inter.color_scale
    intensity = brightness(color_hit)
    color_hit = color_hit * scenelib.materials_at(scene, index).emission
    visible = brightness(color_hit)
    stop = ((intensity < visible) | (visible < cfg.visibility[0])
            | (visible > cfg.visibility[1]))
    depth_hit = torch.where(stop, -depth, depth)

    # miss: sky and terminate
    color_miss = rays.color * sky_color(env, rays.direction)
    depth_miss = -depth
    if cfg.black_background:
        # kill primary misses only (depth < -1: the path had bounced)
        color_miss = color_miss * (depth_miss < -1).to(color_miss.dtype)[
            :, None]

    traced = Rays(
        origin=_where(hit, inter.origin, position),
        direction=_where(hit, inter.direction, rays.direction),
        color=_where(hit, color_hit, color_miss),
        depth=torch.where(hit, depth_hit, depth_miss),
    )
    if completed is not None:
        # in-flight segments: no shading, no depth advance
        traced = _where_rays(completed, traced, rays)
    return traced, t, hit, completed, resume_out


def wavefront_step(scene: Scene, env: Environment, cam: Camera, rays: Rays,
                   accum: torch.Tensor, pixel_id: torch.Tensor, step,
                   cfg: RenderConfig, active: Optional[torch.Tensor] = None,
                   respawn: Optional[torch.Tensor] = None,
                   hit_t: Optional[torch.Tensor] = None,
                   march_state: Optional[torch.Tensor] = None,
                   march_cum: Optional[torch.Tensor] = None):
    """One russian-roulette wavefront step per pixel.

    ``step``: the global step counter (RNG). ``active``: optional per-pixel
    gate (adaptive sampling). ``respawn``: per-pixel camera-sample counter
    (the R2 index under ``cfg.low_discrepancy``). ``hit_t``: primary-hit
    depth buffer. ``march_state``/``march_cum``: the split-march carry; a
    lane whose segment is in flight skips roulette, deposit and respawn.
    Returns ``(rays, accum, respawn, hit_t, march_state, march_cum)``."""
    _check_supported(cfg)
    depth = rays.depth
    dtype = rays.color.dtype
    # split only when the budget divides max_raymarch: an unconverged lane
    # always spends the whole budget, so its count lands on max_raymarch
    split = (cfg.march_split is not None and march_cum is not None
             and cfg.max_raymarch > cfg.march_split
             and cfg.max_raymarch % cfg.march_split == 0)
    marching = (march_cum > 0) if split else None

    # depth-linear roulette: 1 at depth 0, else quality - depth/max (the
    # negative depths of terminated paths boost survival, as the reference)
    u_r = rnglib.uniform(pixel_id, step, _S_ROULETTE, cfg.seed, dtype)
    prob = torch.where(depth == 0, 1.0,
                       cfg.quality_per_sample
                       - depth.to(dtype) * (1.0 / cfg.max_raytrace))
    kill = u_r > prob
    if split:
        kill = kill & ~marching  # mid-segment lanes survived already
    survive = ~kill
    color_surv = rays.color / torch.clamp_min(prob, 1e-8)[:, None]
    if split:
        color_surv = _where(marching, rays.color, color_surv)

    # finished paths deposit and respawn a jittered camera ray
    finished = (depth < 1) | (depth > cfg.max_raytrace)
    if split:
        finished = finished & ~marching
    deposit = finished & survive
    if active is not None:
        deposit = deposit & active
    sample = torch.cat([color_surv, torch.ones_like(u_r)[:, None]], -1)
    accum = accum + _where(deposit, sample, torch.zeros_like(sample))

    if cfg.low_discrepancy and respawn is not None:
        u_cam = rnglib.r2_uniform4(pixel_id, respawn, _S_CAMERA, cfg.seed,
                                   dtype)
    else:
        u_cam = rnglib.uniform4(pixel_id, step, _S_CAMERA, cfg.seed, dtype)
    uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height, u_cam[0],
                            u_cam[1])
    fresh = cameralib.get_ray(cam, uv, u_cam[2], u_cam[3])

    pre = Rays(
        origin=_where(finished, fresh.origin, rays.origin),
        direction=_where(finished, fresh.direction, rays.direction),
        color=_where(finished, fresh.color, color_surv),
        depth=torch.where(finished, 0, depth),
    )
    traced, march_t, march_hit, completed, resume_out = _trace_one_bounce(
        scene, env, pre, pixel_id, step, cfg, active=active,
        resume=(march_state, march_cum) if split else None)

    # killed lanes: zero contribution, terminated; the zero sample deposits
    # at the next step's respawn
    new_rays = Rays(
        origin=_where(survive, traced.origin, rays.origin),
        direction=_where(survive, traced.direction, rays.direction),
        color=_where(survive, traced.color, torch.zeros_like(rays.color)),
        depth=torch.where(survive, traced.depth, -depth),
    )
    if active is not None:
        new_rays = _where_rays(active, new_rays, rays)
    used = finished & survive
    if active is not None:
        used = used & active
    if respawn is not None:
        # advance only where the fresh camera ray was kept
        respawn = respawn + used.to(respawn.dtype)
    if hit_t is not None:
        # record the primary segment's depth where it completed
        rec = used if not split else (completed & (pre.depth == 0)
                                      & survive)
        if split and active is not None:
            rec = rec & active
        hit_t = torch.where(rec, torch.where(march_hit, march_t, NO_HIT_T),
                            hit_t)
    if split:
        ms_new, mc_new = resume_out
        # a killed lane's in-flight segment is dropped with it; gated lanes
        # keep their carry
        mc_new = torch.where(survive, mc_new, 0).to(march_cum.dtype)
        if active is not None:
            ms_new = _where(active, ms_new, march_state)
            mc_new = torch.where(active, mc_new, march_cum)
        march_state, march_cum = ms_new, mc_new
    return new_rays, accum, respawn, hit_t, march_state, march_cum


def render_frame(scene: Scene, env: Environment, cam: Camera,
                 state: FrameState, cfg: RenderConfig, refreshing=False,
                 exposure=1.0):
    """One display frame: optional refresh, ``samples_per_frame x
    samples_per_pixel`` wavefront steps, then postprocess. Returns
    ``(pixels (N, 3), new_state)``."""
    pixel_id = torch.arange(cfg.num_pixels, dtype=torch.int64,
                            device=state.accum.device)
    return render_frame_tile(scene, env, cam, state, cfg, pixel_id,
                             refreshing=refreshing, exposure=exposure)


def render_frame_tile(scene: Scene, env: Environment, cam: Camera,
                      state: FrameState, cfg: RenderConfig,
                      pixel_id: torch.Tensor, refreshing=False,
                      exposure=1.0):
    """``render_frame`` over an explicit tile of global pixel ids; the
    state's tensors are sized to ``pixel_id``."""
    _check_supported(cfg)
    if refreshing:
        state = refresh(state)
    rays, accum = state.rays, state.accum
    # monotone RNG counter: frame index times steps per frame (refresh
    # never resets ``frame``, so draws never repeat)
    steps_per_frame = cfg.samples_per_frame * cfg.samples_per_pixel
    base = state.frame * steps_per_frame

    active = None
    if cfg.adaptive_sampling:
        active = state.noise > cfg.noise_threshold

    respawn, hit_t = state.respawn, state.hit_t
    march_state, march_cum = state.march_state, state.march_cum
    for k in range(steps_per_frame):
        rays, accum, respawn, hit_t, march_state, march_cum = wavefront_step(
            scene, env, cam, rays, accum, pixel_id, base + k, cfg,
            active=active, respawn=respawn, hit_t=hit_t,
            march_state=march_state, march_cum=march_cum)

    pixels, diff_accum, noise = postlib.post_process(
        accum, cfg, exposure, last_pixels=state.pixels,
        diff_accum=state.diff_accum)
    new_state = state.replace(
        rays=rays, accum=accum, frame=state.frame + 1, pixels=pixels,
        respawn=respawn, hit_t=hit_t, march_state=march_state,
        march_cum=march_cum,
        diff_accum=diff_accum if diff_accum is not None
        else state.diff_accum,
        noise=noise if noise is not None else state.noise)
    return pixels, new_state


def render_image_progressive(scene: Scene, env: Environment, cam: Camera,
                             cfg: RenderConfig, spp: int, exposure=1.0,
                             tonemapped: bool = True,
                             max_frames: Optional[int] = None,
                             state: Optional[FrameState] = None,
                             steps_per_frame: int = 8):
    """Offline still through the wavefront: run frames of
    ``steps_per_frame`` steps (overriding ``cfg.samples_per_frame`` /
    ``samples_per_pixel``) until every pixel has ``spp`` completed paths.
    Returns ``((H, W, 3) image, state)``, row 0 at the top. The state is
    made on the scene's device unless given."""
    if state is None:
        state = make_frame_state(cfg.num_pixels, device=scene.device)
    cfg = cfg.replace(samples_per_frame=steps_per_frame, samples_per_pixel=1)
    limit = max_frames if max_frames is not None else (
        spp * 4 // max(steps_per_frame, 1) + 64)
    pixels = None
    for _ in range(limit):
        pixels, state = render_frame(scene, env, cam, state, cfg,
                                     exposure=exposure)
        if float(state.accum[:, 3].min()) >= spp:
            break
    if tonemapped:
        img = pixels
    else:
        img = state.accum[:, :3] / torch.clamp_min(state.accum[:, 3:4], 1.0)
    # flat x-major (W*H) -> (H, W, 3), flipped so row 0 is the top
    img = img.reshape(cfg.width, cfg.height, 3).permute(1, 0, 2)
    return torch.flip(img, dims=(0,)), state
