"""The two integrators (port of ``raytracingpbr_tpu/ops/integrator.py``).

Progressive wavefront: each ``wavefront_step`` advances every pixel's path
by one bounce segment: depth-linear roulette, deposit of finished paths,
thin-lens respawn, then one march + surface interaction. With
``cfg.march_split`` the march runs at most that many trips per step and
unfinished lanes carry their exact loop state in ``FrameState.march_state``
/ ``march_cum``.

Megakernel: ``megakernel_trace`` runs a batch of paths bounce by bounce to
their end (EXP roulette, an unsplit march, the interaction or the sky, the
brightness stop), and ``render_image`` averages ``spp`` such samples per
pixel into a still.

With ``cfg.env_sampling`` both integrators add next-event estimation
toward the environment: at each continuing surface vertex one draw from
the environment's baked alias table and a shadow march (``_nee_env``),
weighted by the lobe roulette's probability of scattering diffusely into
that direction plus a balance-heuristic share of the reflect lobe
(``cfg.mis_specular``); the next segment's sky lookup is weighted by the
complement (``sky_w``: 0 after a diffuse bounce, the reflect lobe's
balance weight after a reflection, 1 otherwise).

Gradients: ``megakernel_trace(differentiable=True)`` (scan-AD) records
the bounce loop in autograd's graph, the march attached at each hit point
(``march._hit_t``) and the normal differentiable in the scene
(``scene.calc_normal``); ``differentiable="replay"`` is path replay
(``ops/replay.py``): material and environment gradients at the
reference's bounce budgets in O(rays) memory. ``wavefront_step`` takes the
same flag for its one bounce.

Every random draw is counter-derived from ``(pixel_id, step, stream,
seed)``. With ``cfg.reprojection``, ``render_frame(prev_cam=...)`` warps
the accumulator into the new view on a refresh (``ops/reproject.py``);
the megakernel ignores the field, as the JAX package's does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..config import HitCriterion, RenderConfig, Roulette
from ..core import rng as rnglib
from ..core.math import brightness
from ..core.types import (NO_HIT_T, Camera, FrameState, Rays,
                          make_frame_state, refresh)
from ..utils import profiling
from . import camera as cameralib
from . import march as marchlib
from . import post as postlib
from . import reproject as reprojectlib
from . import scene as scenelib
from . import shade as shadelib
from .ibl import Environment, env_pdf, sample_env_baked, sky_color
from .scene import Scene

# RNG stream ids (use-sites within one step)
_S_ROULETTE = 0
_S_CAMERA = 1   # jitter x/y + lens u/v
_S_SHADE = 2    # hemisphere u/v + lobe u/v
_S_NEE = 3      # env alias-table draw + in-texel jitter


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)


def _where_rays(mask: torch.Tensor, a: Rays, b: Rays) -> Rays:
    return Rays(*(_where(mask, getattr(a, f.name), getattr(b, f.name))
                  for f in dataclasses.fields(Rays)))


def shadow_march(scene: Scene, origin, direction, cfg: RenderConfig,
                 gate) -> torch.Tensor:
    """Occlusion test of NEE shadow rays: the (N,) bool ``occluded``. The
    escape bound is on (exact for a yes/no query). With
    ``cfg.shadow_diet`` the march is tuned for occlusion: the ABSOLUTE hit
    test at ``cfg.shadow_hit_precision`` (default ``min_dis / 2``) and a
    budget of ``cfg.shadow_max_raymarch`` (default ``min(128,
    max_raymarch)``); a ray that spends its budget counts as visible, as in
    the reference. Lanes outside ``gate`` do no march work."""
    sc = cfg.replace(escape_bound=True)
    if cfg.shadow_diet:
        sc = sc.replace(
            max_raymarch=(cfg.shadow_max_raymarch
                          or min(128, cfg.max_raymarch)),
            hit_criterion=HitCriterion.ABSOLUTE,
            hit_precision=(cfg.shadow_hit_precision or 0.5 * cfg.min_dis))
    return marchlib.march(scene, origin, direction, sc,
                          differentiable=False, active=gate).hit


def _nee_env(scene: Scene, env: Environment, index, position, direction,
             normal, outer, albedo, gate, pixel_id, counter,
             cfg: RenderConfig, roughness_fresnel: bool = False,
             lobe_prob: bool = True, visible_rec=None,
             reflect_kill: Optional[bool] = None):
    """One next-event sample toward the environment at a surface vertex:
    estimates ``integral of L_env(w) P_diffuse(w) (albedo / pi) cos dw``
    with one jittered alias-table draw and a shadow march, where
    ``P_diffuse`` is ``shade.diffuse_lobe_prob`` (skipped with
    ``lobe_prob=False``, the diffuse-only shading). Under
    ``cfg.mis_specular`` it adds the reflect lobe's balance-heuristic
    share, ``w * P_reflect p_spec / p_env`` with the weight ``w = p_env /
    (p_env + p_spec)`` detached. Lanes outside ``gate`` do no march work.
    ``visible_rec``: a recorded visibility mask used in place of the
    shadow march.

    Returns ``(bank (N, 3), visible (N,))``: the banked radiance, to be
    multiplied by the arriving throughput, exactly 0 off the visible lanes,
    and the visibility. Raises ValueError when the environment has no
    baked table."""
    if env.s_prob is None:
        raise ValueError(
            "cfg.env_sampling requires an environment with a baked alias "
            "table — build it with ops.ibl.with_env_sampler(env)")
    dtype = position.dtype
    # four independent uniforms: the cell, the accept test and the jitter
    # inside the texel
    u = rnglib.uniform4(pixel_id, counter, _S_NEE, cfg.seed, dtype)
    d_l, radiance, pdf = sample_env_baked(env, u[0], u[1],
                                          u_jitter=(u[2], u[3]))
    cos = (d_l * normal).sum(-1)
    gate = gate & (cos > 0.0)
    if visible_rec is None:
        origin = position + normal * cfg.min_dis
        visible = gate & ~shadow_march(scene, origin, d_l, cfg, gate)
    else:
        visible = visible_rec
    pdf_safe = torch.clamp_min(pdf, 1e-12)
    scale = cos / (math.pi * pdf_safe)
    if lobe_prob:
        scale = scale * shadelib.diffuse_lobe_prob(
            scene, index, direction, normal, outer, d_l, cfg,
            roughness_fresnel=roughness_fresnel)
        if cfg.mis_specular:
            ps = shadelib.specular_env_density(
                scene, index, direction, normal, outer, d_l, cfg,
                roughness_fresnel=roughness_fresnel,
                reflect_kill=reflect_kill)
            w_l = (pdf_safe / (pdf_safe + torch.clamp_min(ps, 0.0))).detach()
            scale = scale + w_l * ps / pdf_safe
    # one mask, after the products: the reference masks ``scale`` before
    # the lobe product, so a lane whose ray direction is NaN (ROADMAP
    # Queue 3: ``core/rng.hemispheric``'s 0/0) banks 0 * NaN
    bank = albedo * radiance * scale[:, None]
    return torch.where(visible[:, None], bank, torch.zeros_like(bank)), \
        visible


def _next_sky_w(scene: Scene, env: Environment, index, direction, inter,
                new_dir, gate, cfg: RenderConfig,
                roughness_fresnel: bool = False,
                reflect_kill: Optional[bool] = None,
                diffuse=None) -> torch.Tensor:
    """The weight on the next segment's sky lookup after an NEE vertex: 0
    after a diffuse bounce (NEE banked that radiance), the reflect lobe's
    balance weight ``p_spec / (p_env + p_spec)`` after a reflection under
    ``cfg.mis_specular``, 1 otherwise and off ``gate``."""
    ones = torch.ones_like(gate, dtype=direction.dtype)
    nsw = ones
    if cfg.mis_specular and inter is not None:
        ps_b = shadelib.specular_env_density(
            scene, index, direction, inter.normal, inter.outer, new_dir, cfg,
            roughness_fresnel=roughness_fresnel, reflect_kill=reflect_kill)
        w_b = (ps_b / torch.clamp_min(env_pdf(env, new_dir) + ps_b,
                                      1e-20)).detach()
        nsw = torch.where(inter.reflect, w_b, nsw)
    diffuse = inter.diffuse if diffuse is None else diffuse
    nsw = torch.where(diffuse, torch.zeros_like(nsw), nsw)
    return torch.where(gate, nsw, ones)


def _trace_one_bounce(scene: Scene, env: Environment, rays: Rays,
                      pixel_id: torch.Tensor, counter, cfg: RenderConfig,
                      differentiable: bool = False,
                      active: Optional[torch.Tensor] = None,
                      prev_sky_w: Optional[torch.Tensor] = None,
                      resume=None):
    """One bounce: march, surface interaction or sky, emission, brightness
    termination.

    ``prev_sky_w``: with ``cfg.env_sampling``, the weight on this segment's
    sky lookup (see the module docstring). NEE then banks at every vertex
    whose path continues (a hit that does not stop, under the bounce cap,
    active, its segment completed).

    ``resume``: the split-march carry ``(march_state (N,4), march_cum
    (N,))``. The march then runs at most ``cfg.march_split`` trips; lanes
    whose segment neither hit nor escaped, and has not used up
    ``cfg.max_raymarch``, are returned unchanged in ``traced`` with their
    loop state in ``resume_out``.

    ``differentiable``: attach the march's hit-point gradients
    (``march._hit_t``; under a split march on the lanes whose segment
    completed).

    Returns ``(traced, t, hit, nee, next_sky_w, completed, resume_out)``;
    ``nee`` and ``next_sky_w`` are None without ``cfg.env_sampling``,
    ``completed`` and ``resume_out`` without ``resume``."""
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
        if differentiable:
            t = marchlib._hit_t(scene, rays.origin, rays.direction, t, index,
                                hit & completed)
        # completed lanes re-arm next step; in-flight lanes carry the exact
        # loop state (gated-inactive lanes echo their init and pause)
        resume_out = (
            _where(completed, torch.zeros_like(mstate),
                   torch.stack([rr.t, rr.w, rr.s, rr.d], dim=-1)),
            torch.where(completed, 0, cum_new).to(mcum.dtype))
    else:
        res = marchlib.march(scene, rays.origin, rays.direction, cfg,
                             differentiable=differentiable, active=active)
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

    nee = next_sky_w = None
    if cfg.env_sampling:
        if prev_sky_w is not None:
            color_miss = color_miss * prev_sky_w[:, None]
        # bank only where the path continues: a stopped lane's plain
        # estimate never looks at the sky again, and a lane at the bounce
        # cap deposits before its next lookup
        gate = hit & ~stop & (depth <= cfg.max_raytrace)
        if active is not None:
            gate = gate & active
        if completed is not None:
            gate = gate & completed
        # the raw albedo: the bank must not depend on this vertex's lobe
        albedo = scenelib.materials_at(scene, index).albedo
        nee, _ = _nee_env(scene, env, index, position, rays.direction,
                          inter.normal, inter.outer, albedo, gate, pixel_id,
                          counter, cfg)
        nee = rays.color * nee
        next_sky_w = _next_sky_w(scene, env, index, rays.direction, inter,
                                 inter.direction, gate, cfg)

    traced = Rays(
        origin=_where(hit, inter.origin, position),
        direction=_where(hit, inter.direction, rays.direction),
        color=_where(hit, color_hit, color_miss),
        depth=torch.where(hit, depth_hit, depth_miss),
    )
    if completed is not None:
        # in-flight segments: no shading, no depth advance
        traced = _where_rays(completed, traced, rays)
        if next_sky_w is not None:
            keep = (prev_sky_w if prev_sky_w is not None
                    else torch.ones_like(next_sky_w))
            next_sky_w = torch.where(completed, next_sky_w, keep)
    return traced, t, hit, nee, next_sky_w, completed, resume_out


@profiling.traced("step")
def wavefront_step(scene: Scene, env: Environment, cam: Camera, rays: Rays,
                   accum: torch.Tensor, pixel_id: torch.Tensor, step,
                   cfg: RenderConfig, active: Optional[torch.Tensor] = None,
                   respawn: Optional[torch.Tensor] = None,
                   hit_t: Optional[torch.Tensor] = None,
                   sky_w: Optional[torch.Tensor] = None,
                   march_state: Optional[torch.Tensor] = None,
                   march_cum: Optional[torch.Tensor] = None,
                   differentiable: bool = False):
    """One russian-roulette wavefront step per pixel.

    ``step``: the global step counter (RNG). ``active``: optional per-pixel
    gate (adaptive sampling). ``respawn``: per-pixel camera-sample counter
    (the R2 index under ``cfg.low_discrepancy``). ``hit_t``: primary-hit
    depth buffer. ``sky_w``: the weight on each path's next sky lookup
    (``cfg.env_sampling``; ``FrameState.sky_w``); NEE banks into ``accum``
    without counting a sample. ``march_state``/``march_cum``: the
    split-march carry; a lane whose segment is in flight skips roulette,
    deposit and respawn. ``differentiable``: attach the march's hit-point
    gradients (``march._hit_t``). Returns ``(rays, accum, respawn, hit_t,
    sky_w, march_state, march_cum)``."""
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
    prev_sky_w = None
    if cfg.env_sampling and sky_w is not None:
        # a respawned lane starts a fresh path: a plain sky lookup
        prev_sky_w = torch.where(finished, torch.ones_like(sky_w), sky_w)
    traced, march_t, march_hit, nee, next_sky_w, completed, resume_out = \
        _trace_one_bounce(scene, env, pre, pixel_id, step, cfg,
                          differentiable=differentiable, active=active,
                          prev_sky_w=prev_sky_w,
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
    keep = survive if active is None else survive & active
    if nee is not None:
        # part of the in-flight path's estimate: no sample is counted
        accum = accum + torch.cat(
            [_where(keep, nee, torch.zeros_like(nee)),
             torch.zeros_like(u_r)[:, None]], -1)
    if sky_w is not None and next_sky_w is not None:
        sky_w = torch.where(keep, next_sky_w,
                            prev_sky_w if prev_sky_w is not None else sky_w)
    if split:
        ms_new, mc_new = resume_out
        # a killed lane's in-flight segment is dropped with it; gated lanes
        # keep their carry
        mc_new = torch.where(survive, mc_new, 0).to(march_cum.dtype)
        if active is not None:
            ms_new = _where(active, ms_new, march_state)
            mc_new = torch.where(active, mc_new, march_cum)
        march_state, march_cum = ms_new, mc_new
    return new_rays, accum, respawn, hit_t, sky_w, march_state, march_cum


def render_frame(scene: Scene, env: Environment, cam: Camera,
                 state: FrameState, cfg: RenderConfig, refreshing=False,
                 exposure=1.0, prev_cam: Optional[Camera] = None):
    """One display frame: optional refresh, ``samples_per_frame x
    samples_per_pixel`` wavefront steps, then postprocess. Returns
    ``(pixels (N, 3), new_state)``.

    With ``cfg.reprojection`` and a ``prev_cam``, a refresh warps the
    accumulator from ``prev_cam``'s view into ``cam``'s
    (``ops/reproject.reproject``) in place of zeroing it. Without
    ``prev_cam`` the frame renders as usual."""
    if cfg.reprojection and prev_cam is not None:
        if refreshing:
            state = reprojectlib.reproject(state, prev_cam, cam, cfg)
        refreshing = False  # the warp re-armed the state
    pixel_id = torch.arange(cfg.num_pixels, dtype=torch.int64,
                            device=state.accum.device)
    return render_frame_tile(scene, env, cam, state, cfg, pixel_id,
                             refreshing=refreshing, exposure=exposure)


@profiling.traced("frame")
def render_frame_tile(scene: Scene, env: Environment, cam: Camera,
                      state: FrameState, cfg: RenderConfig,
                      pixel_id: torch.Tensor, refreshing=False,
                      exposure=1.0):
    """``render_frame`` over an explicit tile of global pixel ids; the
    state's tensors are sized to ``pixel_id``."""
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

    respawn, hit_t, sky_w = state.respawn, state.hit_t, state.sky_w
    march_state, march_cum = state.march_state, state.march_cum
    for k in range(steps_per_frame):
        (rays, accum, respawn, hit_t, sky_w, march_state,
         march_cum) = wavefront_step(
            scene, env, cam, rays, accum, pixel_id, base + k, cfg,
            active=active, respawn=respawn, hit_t=hit_t, sky_w=sky_w,
            march_state=march_state, march_cum=march_cum)

    pixels, diff_accum, noise = postlib.post_process(
        accum, cfg, exposure, last_pixels=state.pixels,
        diff_accum=state.diff_accum)
    new_state = state.replace(
        rays=rays, accum=accum, frame=state.frame + 1, pixels=pixels,
        respawn=respawn, hit_t=hit_t, sky_w=sky_w, march_state=march_state,
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


# ---------------------------------------------------------------------------
# Megakernel
# ---------------------------------------------------------------------------

# The forward loop ends once no lane is alive. It asks the card every
# EXIT_CHECK_EVERY bounces, and the answer stalls the host until the bounce
# has run; a bounce with no lane alive changes nothing (every update is
# gated by ``alive``), so the image is the same for any value, but it costs
# as much as any other. Measured on the H100 (PERF.md), asking every bounce
# beat every 2, 4, 8 and 16 on the Cornell pass by 5-71% and came within 4%
# of the best (every 8) on the glass pass.
EXIT_CHECK_EVERY = 1
_MASK = 0xFFFFFFFF


def any_alive(alive: torch.Tensor) -> bool:
    """Whether any lane is alive: a host sync, in the ``sync`` span."""
    with profiling.span("sync"):
        return bool(alive.any())


class TraceResult(NamedTuple):
    color: torch.Tensor    # (N, 3) radiance estimate per ray
    bounces: torch.Tensor  # (N,) i32 bounce count (diagnostics)


def _sample_base(sample_idx, max_bounce: int):
    """``sample_idx * max_bounce`` for the bounce counters ``(base + i)``
    modulo 2**32: an int, or an int64 tensor of per-lane values."""
    if isinstance(sample_idx, torch.Tensor):
        return (sample_idx.to(torch.int64) & _MASK) * max_bounce
    return (int(sample_idx) & _MASK) * max_bounce


def megakernel_trace(scene: Scene, env: Environment, rays: Rays,
                     pixel_id: torch.Tensor, sample_idx,
                     cfg: RenderConfig, diffuse_only: bool = False,
                     differentiable=False, roughness_fresnel: bool = True,
                     restart_at_hit: bool = True,
                     reflect_kill: Optional[bool] = None) -> TraceResult:
    """Full bounce loop per sample: EXP russian roulette
    (``1 - 1/exp(i/light_quality)``), an unsplit march of
    ``cfg.max_raymarch`` trips gated by ``alive``, the interaction, the
    brightness stop; a miss multiplies the sky color and stops.

    ``differentiable``: False (a forward render, no graph recorded), True
    (scan-AD: the loop runs under autograd with the march attached at each
    hit, geometry gradients included; memory grows with the bounces the
    loop runs), or ``"replay"`` (path replay, ``ops/replay.trace_replay``:
    material and environment gradients in O(rays) memory). The JAX package
    scans a fixed ``max_raytrace`` bounces for scan-AD only because its
    while loop has no transpose; a bounce with no lane alive changes
    nothing, so the loop here ends when none is, in every mode.

    With ``cfg.env_sampling`` every continuing vertex but the last
    bounce's banks NEE radiance (under EXP roulette times the
    continuation's survival probability ``exp(-(i + 1) / light_quality)``,
    which the plain estimator's next sky lookup would have needed), and
    the sky lookups are weighted by ``sky_w``; the banked radiance is added
    to the colour at the end.

    ``diffuse_only`` is the minimal Cornell box's shading: a cosine
    hemisphere about the outward normal, the albedo as the throughput.
    ``reflect_kill`` (None: ``roughness_fresnel and not differentiable``)
    zeroes a below-surface reflection; the differentiable estimators fold
    it back above, since the kill is a step in the geometry whose gradient
    is 0 almost everywhere. ``sample_idx``: the sample's uint32 index (an
    int, or an (N,) integer tensor of per-lane indices); the bounce's RNG
    counter is ``sample_idx * cfg.max_raytrace + i`` modulo 2**32, as the
    reference's uint32 arithmetic wraps. The loop asks whether any lane is
    alive every :data:`EXIT_CHECK_EVERY` bounces; the result does not
    depend on it."""
    if reflect_kill is None:
        reflect_kill = roughness_fresnel and not differentiable
    if differentiable == "replay":
        from .replay import trace_replay
        color = trace_replay(scene, env, rays, pixel_id, sample_idx, cfg,
                             diffuse_only=diffuse_only,
                             roughness_fresnel=roughness_fresnel,
                             restart_at_hit=restart_at_hit,
                             reflect_kill=reflect_kill)
        return TraceResult(color, torch.zeros_like(rays.depth))
    dtype = rays.color.dtype
    max_bounce = cfg.max_raytrace
    base = _sample_base(sample_idx, max_bounce)

    origin, direction, color = rays.origin, rays.direction, rays.color
    alive = torch.ones(origin.shape[:1], dtype=torch.bool,
                       device=origin.device)
    bounces = torch.zeros(origin.shape[:1], dtype=torch.int32,
                          device=origin.device)
    if cfg.env_sampling:
        # banked NEE radiance, and the weight on the next sky lookup
        radiance = torch.zeros_like(color)
        sky_w = torch.ones_like(origin[:, 0])
    with contextlib.nullcontext() if differentiable else torch.no_grad():
        i = 0
        while i < max_bounce:
            with profiling.span("bounce"):
                counter = (base + i) & _MASK
                if cfg.roulette == Roulette.EXP:
                    # a lane that dies keeps its colour times the probability,
                    # and one that survives gets no 1/p (the reference's quirk)
                    inv_pdf = torch.exp(torch.tensor(i, dtype=dtype)
                                        / cfg.light_quality)
                    roulette_prob = float(1.0 - 1.0 / inv_pdf)
                    u = rnglib.uniform(pixel_id, counter, _S_ROULETTE,
                                       cfg.seed, dtype)
                    die = u < roulette_prob
                    color = torch.where((alive & die)[:, None],
                                        color * roulette_prob, color)
                    alive = alive & ~die
                # (DEPTH_LINEAR roulette belongs to the wavefront.)

                res = marchlib.march(scene, origin, direction, cfg,
                                     differentiable=bool(differentiable),
                                     active=alive)

                u4 = rnglib.uniform4(pixel_id, counter, _S_SHADE, cfg.seed,
                                     dtype)
                mat = scenelib.materials_at(scene, res.index)
                if diffuse_only:
                    normal = scenelib.calc_normal(scene, res.index,
                                                  res.position)
                    outer = (direction * normal).sum(-1) < 0.0
                    normal = _where(outer, normal, -normal)
                    new_dir = rnglib.hemispheric(normal, u4[0], u4[1])
                    new_origin = res.position
                    color_scale = mat.albedo
                    inter = None
                else:
                    inter = shadelib.ray_surface_interaction(
                        scene, res.index, res.position, direction, u4, cfg,
                        roughness_fresnel=roughness_fresnel,
                        restart_at_hit=restart_at_hit,
                        reflect_kill=reflect_kill)
                    new_dir, new_origin = inter.direction, inter.origin
                    color_scale = inter.color_scale
                    normal = inter.normal

                # hit: throughput, emission, brightness termination
                color_hit = color * color_scale
                intensity = brightness(color_hit)
                color_hit = color_hit * mat.emission
                visible = brightness(color_hit)
                stop_hit = ((intensity < visible)
                            | (visible < cfg.visibility[0])
                            | (visible > cfg.visibility[1]))
                # miss: the sky, and stop (black_background is the wavefront's)
                color_miss = color * sky_color(env, direction)

                if cfg.env_sampling:
                    color_miss = color_miss * sky_w[:, None]
                    # no bank on the last bounce: the loop ends before the sky
                    # lookup it stands in for
                    gate = alive & res.hit & ~stop_hit & (i < max_bounce - 1)
                    if diffuse_only:
                        nee, _ = _nee_env(scene, env, res.index, res.position,
                                          direction, normal,
                                          torch.ones_like(gate), mat.albedo,
                                          gate, pixel_id, counter, cfg,
                                          lobe_prob=False)
                    else:
                        nee, _ = _nee_env(scene, env, res.index, res.position,
                                          direction, normal, inter.outer,
                                          mat.albedo, gate, pixel_id, counter,
                                          cfg,
                                          roughness_fresnel=roughness_fresnel,
                                          reflect_kill=reflect_kill)
                    if cfg.roulette == Roulette.EXP:
                        nee = nee * torch.exp(-(torch.tensor(i, dtype=dtype)
                                                + 1.0) / cfg.light_quality)
                    radiance = radiance + _where(gate, color * nee,
                                                 torch.zeros_like(nee))
                    nsw = _next_sky_w(
                        scene, env, res.index, direction, inter, new_dir, gate,
                        cfg, roughness_fresnel=roughness_fresnel,
                        reflect_kill=reflect_kill,
                        diffuse=(torch.ones_like(gate) if diffuse_only
                                 else None))
                    sky_w = torch.where(alive, nsw, sky_w)

                on = alive & res.hit
                color = _where(on, color_hit,
                               _where(alive & ~res.hit, color_miss, color))
                origin = _where(on, new_origin, origin)
                direction = _where(on, new_dir, direction)
                bounces = bounces + on.to(torch.int32)
                alive = on & ~stop_hit
                i += 1
                if i % EXIT_CHECK_EVERY == 0 and not any_alive(alive):
                    break
    if cfg.env_sampling:
        color = color + radiance
    # paths still alive after max_raytrace bounces keep their colour
    return TraceResult(color, bounces)


def sample_sum(scene: Scene, env: Environment, cam: Camera,
               cfg: RenderConfig, pixel_id: torch.Tensor, first, spp: int,
               **trace_kw) -> torch.Tensor:
    """The sum (N, 3) of ``spp`` megakernel samples of each of ``pixel_id``
    (N,), sample ids ``first + k`` modulo 2**32 (``first`` an int, or an
    int64 tensor (N,) of each lane's first id), each camera ray drawn
    through ``rng.sampler4(cfg.low_discrepancy)``. ``trace_kw`` go to
    :func:`megakernel_trace`."""
    sampler = rnglib.sampler4(cfg.low_discrepancy)
    acc = torch.zeros((pixel_id.shape[0], 3), dtype=torch.float32,
                      device=pixel_id.device)
    for k in range(spp):
        idx = (first + k) & _MASK
        u_cam = sampler(pixel_id, idx, _S_CAMERA, cfg.seed)
        uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height, u_cam[0],
                                u_cam[1])
        rays = cameralib.get_ray(cam, uv, u_cam[2], u_cam[3])
        acc = acc + megakernel_trace(scene, env, rays, pixel_id, idx, cfg,
                                     **trace_kw).color
    return acc


def render_image(scene: Scene, env: Environment, cam: Camera,
                 cfg: RenderConfig, spp: Optional[int] = None,
                 sample_offset: int = 0, exposure=1.0,
                 diffuse_only: bool = False, differentiable=False,
                 tonemapped: bool = True, roughness_fresnel: bool = True,
                 restart_at_hit: bool = True,
                 reflect_kill: Optional[bool] = None) -> torch.Tensor:
    """Offline still: the mean of ``spp`` megakernel samples per pixel
    (:func:`sample_sum` from ``sample_offset``), tonemapped unless
    ``tonemapped=False``. Runs on the scene's device. ``differentiable``
    as in :func:`megakernel_trace`. Returns (H, W, 3), row 0 at the
    top."""
    n = cfg.num_pixels
    spp = spp if spp is not None else cfg.samples_per_pixel
    pixel_id = torch.arange(n, dtype=torch.int64, device=scene.device)
    accum = sample_sum(scene, env, cam, cfg, pixel_id, int(sample_offset),
                       spp, diffuse_only=diffuse_only,
                       differentiable=differentiable,
                       roughness_fresnel=roughness_fresnel,
                       restart_at_hit=restart_at_hit,
                       reflect_kill=reflect_kill)
    mean = accum / spp
    img = postlib.tonemap(mean, cfg, exposure) if tonemapped else mean
    # flat x-major (W*H) -> (H, W, 3), flipped so row 0 is the top
    img = img.reshape(cfg.width, cfg.height, 3).permute(1, 0, 2)
    return torch.flip(img, dims=(0,))
