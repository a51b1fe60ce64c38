"""Path-replay backpropagation for the megakernel integrator (port of
``raytracingpbr_tpu/ops/replay.py``).

Scan-AD (``integrator.megakernel_trace(differentiable=True)``) keeps every
bounce's intermediates in autograd's graph: fine at 4-8 bounces, not at
the reference's 128-512. Path replay re-simulates the path in the
backward pass from the counter RNG instead, so backward memory is O(rays)
whatever the bounce budget, at about one extra forward pass.

The megakernel radiance of a lane is

    C = C_path + sum_i B_i
    C_path = color0 * prod_j s_j,  s_j = albedo_j * emission_j   (a hit)
                                       | sky(env, direction_j)   (the miss)
                                       | roulette_prob_j         (theta-free)
    B_i = color0 * (prod_{j<i} s_j) * b_i          (the NEE bank)

so ``dC/dtheta = sum_j [(C_path + sum_{i>j} B_i) / s_j] ds_j/dtheta +
sum_i [prefix_i] db_i/dtheta``: a factor's cotangent is the radiance
collected after it, a bank factor's the throughput arriving at it. The
backward replays each bounce with the forward's counters (the same path,
bit for bit), forms these cotangents from running prefix sums against the
forward's totals, and takes one small VJP of the bounce's local factors
(``torch.autograd.grad`` on the scene's and the environment's tensors).
Exactly-zero factors (black albedo, a killed reflection, the zeroed sky
after a banked vertex) are counted apart (``zcount``, with ``pnz`` the
product of the nonzero ones), so the product rule stays exact where the
ratio would lose the gradient.

March checkpoint (``cfg.replay_march_checkpoint``): the backward needs of
each march only ``(t, index, hit)`` (and under NEE the shadow ray's
visibility); recorded per bounce in the forward they spare every
re-march, at about 8 bytes a ray a bounce. ``trace_replay`` turns it on
when the record of ``cfg.max_raytrace`` bounces fits in 1 GiB.

Scope, as in the reference (detached path sampling, Vicini et al. 2021):
gradients reach every parameter of the throughput and bank factors:
albedo, emission, the environment, and through the NEE lobe probability
roughness, metallic, transmission and ior. Geometry needs scan-AD.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig, Roulette
from ..core import rng as rnglib
from ..core.math import brightness
from ..core.types import Rays
from . import integrator as integ
from . import march as marchlib
from . import scene as scenelib
from . import shade as shadelib
from .ibl import Environment, sky_color
from .scene import Scene

# the environment's float tensors that can take gradients
_ENV_FIELDS = ("image", "scale", "color_a", "color_b", "s_prob", "s_pdf")


class _Static(NamedTuple):
    """The trace's options."""
    cfg: RenderConfig
    diffuse_only: bool
    roughness_fresnel: bool
    restart_at_hit: bool
    reflect_kill: bool = False
    checkpoint: bool = False


class _BounceOut(NamedTuple):
    """What one replayed bounce produces (forward or backward)."""
    origin: torch.Tensor
    direction: torch.Tensor
    color: torch.Tensor        # throughput after this bounce's factor
    alive: torch.Tensor
    s: torch.Tensor            # (N, 3) this bounce's throughput factor
    hit_applied: torch.Tensor  # (N,) the hit factor was applied
    miss_applied: torch.Tensor  # (N,) the sky factor was applied
    index: torch.Tensor        # (N,) hit object
    zcount: torch.Tensor       # running count of zero factors
    pnz: torch.Tensor          # running product of the nonzero factors
    killed: torch.Tensor       # (N,) reflect_kill at this vertex
    t: torch.Tensor            # (N,) the march's t (checkpoint record)
    hit: torch.Tensor          # (N,) the march's hit (checkpoint record)
    # cfg.env_sampling only (None otherwise):
    sky_w: Optional[torch.Tensor]     # the next segment's sky weight
    sky_mask: Optional[torch.Tensor]  # the weight on THIS bounce's sky
    gate: Optional[torch.Tensor]      # (N,) the NEE bank's gate
    vis: Optional[torch.Tensor]       # (N,) the shadow ray's visibility
    bank: Optional[torch.Tensor]      # (N, 3) banked radiance
    bz: Optional[torch.Tensor]        # (N, 3) single-zero-prefix bank term
    normal: Optional[torch.Tensor]    # (N, 3) faced normal
    outer: Optional[torch.Tensor]     # (N,) sidedness


def _counter(cfg: RenderConfig, sample_idx, i: int):
    """The bounce's RNG counter, ``sample_idx * max_raytrace + i`` modulo
    2**32 (``integrator.megakernel_trace``'s)."""
    base = integ._sample_base(sample_idx, cfg.max_raytrace)
    return (base + i) & integ._MASK


def _nee_comp(cfg: RenderConfig, i: int, dtype):
    """The bank's truncation compensation under EXP roulette: the paired
    continuation's survival ``exp(-(i + 1) / light_quality)``."""
    if cfg.roulette == Roulette.EXP:
        return torch.exp(-(torch.tensor(i, dtype=dtype) + 1.0)
                         / cfg.light_quality)
    return None


def _bounce_state(static: _Static, scene: Scene, env: Environment, origin,
                  direction, color, alive, pixel_id, i: int, sample_idx,
                  zcount, pnz, prev_sky_w=None, march_rec=None,
                  vis_rec=None) -> _BounceOut:
    """One megakernel bounce, statement for statement
    ``integrator.megakernel_trace``'s body (the same counters and the same
    f32 operations in the same order, so the replayed path is bit-exact to
    the forward render), plus the throughput factor ``s`` with where it
    applied, the zero-factor bookkeeping and under ``cfg.env_sampling`` the
    bank's pieces.

    ``march_rec=(t, enc)``: the recorded march of this bounce (``enc >= 0``
    is the hit object), in place of the sphere trace; ``vis_rec``: the
    recorded shadow visibility, in place of the shadow march."""
    cfg = static.cfg
    dtype = color.dtype
    counter = _counter(cfg, sample_idx, i)

    if cfg.roulette == Roulette.EXP:
        inv_pdf = torch.exp(torch.tensor(i, dtype=dtype) / cfg.light_quality)
        roulette_prob = float(1.0 - 1.0 / inv_pdf)
        u = rnglib.uniform(pixel_id, counter, integ._S_ROULETTE, cfg.seed,
                           dtype)
        die = u < roulette_prob
        dying = (alive & die)[:, None]
        color = torch.where(dying, color * roulette_prob, color)
        # the roulette factor is theta-free but part of the product
        if roulette_prob == 0.0:
            zcount = zcount + dying.expand_as(zcount).to(zcount.dtype)
        else:
            pnz = torch.where(dying, pnz * roulette_prob, pnz)
        alive = alive & ~die

    if march_rec is None:
        res = marchlib.march(scene, origin, direction, cfg,
                             differentiable=False, active=alive)
        m_t, m_idx, m_hit, m_pos = res.t, res.index, res.hit, res.position
    else:
        m_t, enc = march_rec
        m_hit = enc >= 0
        m_idx = torch.clamp_min(enc, 0)
        m_pos = origin + m_t[:, None] * direction

    u4 = rnglib.uniform4(pixel_id, counter, integ._S_SHADE, cfg.seed, dtype)
    mat = scenelib.materials_at(scene, m_idx)
    if static.diffuse_only:
        normal = scenelib.calc_normal(scene, m_idx, m_pos)
        outer = (direction * normal).sum(-1) < 0.0
        normal = integ._where(outer, normal, -normal)
        new_dir = rnglib.hemispheric(normal, u4[0], u4[1])
        new_origin = m_pos
        color_scale = mat.albedo
        inter = None
        killed = torch.zeros_like(m_hit)
        outer_bit = torch.ones_like(m_hit)
    else:
        inter = shadelib.ray_surface_interaction(
            scene, m_idx, m_pos, direction, u4, cfg,
            roughness_fresnel=static.roughness_fresnel,
            restart_at_hit=static.restart_at_hit,
            reflect_kill=static.reflect_kill)
        new_dir, new_origin = inter.direction, inter.origin
        color_scale = inter.color_scale
        normal, killed, outer_bit = inter.normal, inter.killed, inter.outer

    color_hit = color * color_scale
    intensity = brightness(color_hit)
    color_hit = color_hit * mat.emission
    visible = brightness(color_hit)
    stop_hit = ((intensity < visible) | (visible < cfg.visibility[0])
                | (visible > cfg.visibility[1]))
    color_miss = color * sky_color(env, direction)

    sky_mask = gate = vis = bank = bz = None
    sky_w = prev_sky_w
    if cfg.env_sampling:
        sky_mask = prev_sky_w
        color_miss = color_miss * sky_mask[:, None]
        gate = alive & m_hit & ~stop_hit & (i < cfg.max_raytrace - 1)
        if static.diffuse_only:
            nee, vis = integ._nee_env(
                scene, env, m_idx, m_pos, direction, normal,
                torch.ones_like(gate), mat.albedo, gate, pixel_id, counter,
                cfg, lobe_prob=False, visible_rec=vis_rec)
        else:
            nee, vis = integ._nee_env(
                scene, env, m_idx, m_pos, direction, normal, outer_bit,
                mat.albedo, gate, pixel_id, counter, cfg,
                roughness_fresnel=static.roughness_fresnel,
                reflect_kill=static.reflect_kill, visible_rec=vis_rec)
        comp = _nee_comp(cfg, i, dtype)
        if comp is not None:
            nee = nee * comp
        zeros = torch.zeros_like(nee)
        bank = integ._where(gate, color * nee, zeros)
        # a prefix with exactly one zero factor: d(bank)/d(that factor) is
        # the other prefix factors' product times the bank factor
        bz = torch.where((zcount == 1) & gate[:, None], pnz * nee, zeros)
        nsw = integ._next_sky_w(
            scene, env, m_idx, direction, inter, new_dir, gate, cfg,
            roughness_fresnel=static.roughness_fresnel,
            reflect_kill=static.reflect_kill,
            diffuse=torch.ones_like(gate) if static.diffuse_only else None)
        sky_w = torch.where(alive, nsw, prev_sky_w)

    hit_applied = alive & m_hit
    miss_applied = alive & ~m_hit
    color = integ._where(hit_applied, color_hit,
                         integ._where(miss_applied, color_miss, color))
    new_origin = integ._where(hit_applied, new_origin, origin)
    new_direction = integ._where(hit_applied, new_dir, direction)
    alive = hit_applied & ~stop_hit

    # the factor, for the cotangents (the carry does not use it)
    s_miss = sky_color(env, direction)
    if sky_mask is not None:
        s_miss = s_miss * sky_mask[:, None]
    s = integ._where(hit_applied, color_scale * mat.emission,
                     integ._where(miss_applied, s_miss,
                                  torch.ones_like(color)))
    applied = (hit_applied | miss_applied)[:, None]
    sz = applied & (s == 0.0)
    pnz = torch.where(applied & ~sz, pnz * s, pnz)
    zcount = zcount + sz.to(zcount.dtype)
    return _BounceOut(new_origin, new_direction, color, alive, s,
                      hit_applied, miss_applied, m_idx, zcount, pnz, killed,
                      m_t, m_hit, sky_w, sky_mask, gate, vis, bank, bz,
                      normal, outer_bit)


def _init(color0, origin):
    """The carry before bounce 0: all alive, color0's zeros counted."""
    c0z = color0 == 0.0
    alive = torch.ones(origin.shape[:1], dtype=torch.bool,
                       device=origin.device)
    return (alive, c0z.to(torch.int32),
            torch.where(c0z, torch.ones_like(color0), color0))


def _forward(static: _Static, scene, env, origin, direction, color0,
             pixel_id, sample_idx):
    """The early-exit trace. Returns ``(C_path, aux)``: ``aux`` holds the
    bounces run, ``zcount`` and ``pnz`` (per lane and channel: the count of
    exactly-zero factors, color0 included, and the product of the nonzero
    ones; with them ``dC/ds_i`` is ``pnz`` where ``s_i`` is the only zero
    and 0 where two are), under ``cfg.env_sampling`` the bank's total and
    its single-zero companion ``bz_tot``, and with ``static.checkpoint``
    the march record of each bounce run."""
    cfg = static.cfg
    env_s = cfg.env_sampling
    alive, zcount, pnz = _init(color0, origin)
    color = color0
    sky_w = (torch.ones(origin.shape[:1], dtype=color0.dtype,
                        device=origin.device) if env_s else None)
    bank_tot = torch.zeros_like(color0) if env_s else None
    bz_tot = torch.zeros_like(color0) if env_s else None
    rec = []
    n_bounce = 0
    while n_bounce < cfg.max_raytrace and integ.any_alive(alive):
        out = _bounce_state(static, scene, env, origin, direction, color,
                            alive, pixel_id, n_bounce, sample_idx, zcount,
                            pnz, prev_sky_w=sky_w)
        origin, direction, color, alive = (out.origin, out.direction,
                                           out.color, out.alive)
        zcount, pnz, sky_w = out.zcount, out.pnz, out.sky_w
        if env_s:
            bank_tot = bank_tot + out.bank
            bz_tot = bz_tot + out.bz
        if static.checkpoint:
            rec.append((out.t, torch.where(out.hit, out.index, -1),
                        out.vis))
        n_bounce += 1
    return color, dict(n_bounce=n_bounce, zcount=zcount, pnz=pnz,
                       bank_tot=bank_tot, bz_tot=bz_tot, rec=rec)


class _ReplayTrace(torch.autograd.Function):
    """The megakernel radiance with the path-replay backward. The scene's
    float buffers (``scene.params``' order) and the environment's float
    tensors (``_ENV_FIELDS`` present) come in as the flat tensor arguments
    ``params``; the first ``n_scene`` are the scene's. The forward records
    no graph (autograd's rule for a Function), so memory stays O(rays)."""

    @staticmethod
    def forward(ctx, static, scene, env, origin, direction, color0,
                pixel_id, sample_idx, n_scene, *params):
        color, aux = _forward(static, scene, env, origin, direction, color0,
                              pixel_id, sample_idx)
        ctx.static, ctx.scene, ctx.env = static, scene, env
        ctx.sample_idx, ctx.n_scene, ctx.aux = sample_idx, n_scene, aux
        ctx.save_for_backward(origin, direction, color0, pixel_id, color)
        if static.cfg.env_sampling:
            return color + aux["bank_tot"]
        return color

    @staticmethod
    def backward(ctx, g):
        origin, direction, color0, pixel_id, c_path = ctx.saved_tensors
        grads = _replay_bwd(ctx.static, ctx.scene, ctx.env, origin,
                            direction, color0, pixel_id, ctx.sample_idx,
                            c_path, ctx.aux, ctx.n_scene,
                            ctx.needs_input_grad[9:], g)
        d_params, dcolor0 = grads
        return (None, None, None, torch.zeros_like(origin),
                torch.zeros_like(direction), dcolor0, None, None, None,
                *d_params)


def _env_names(env: Environment):
    return tuple(k for k in _ENV_FIELDS
                 if isinstance(getattr(env, k), torch.Tensor))


def _replay_bwd(static: _Static, scene, env, origin0, direction0, color0,
                pixel_id, sample_idx, c_path, aux, n_scene, want, g):
    """Replays the forward's bounces with its counters and accumulates
    each bounce's local VJP. Returns ``(param grads in the Function's
    order, None where not wanted; dC/dcolor0)``."""
    cfg = static.cfg
    env_s = cfg.env_sampling
    zcount, pnz = aux["zcount"], aux["pnz"]
    u = g * c_path      # u / s_i = g * (C_path without factor i)
    gp = g * pnz        # the cotangent of a channel's one zero factor
    no_zero = zcount == 0
    one_zero = zcount == 1
    if env_s:
        bank_tot, bz_tot = aux["bank_tot"], aux["bz_tot"]

    e_names = _env_names(env)
    tensors = scenelib.params(scene) + tuple(getattr(env, k)
                                             for k in e_names)
    leaves = [v.detach().requires_grad_(w) for v, w in zip(tensors, want)]
    sc = scenelib.with_params(scene, leaves[:n_scene])
    en = env.replace(**dict(zip(e_names, leaves[n_scene:])))
    sel = [v for v, w in zip(leaves, want) if w]
    acc = [torch.zeros_like(v) for v in sel]

    alive, zc, pz = _init(color0, origin0)
    origin, direction, color = origin0, direction0, color0
    sky_w = (torch.ones(origin0.shape[:1], dtype=color0.dtype,
                        device=origin0.device) if env_s else None)
    bank_pre = torch.zeros_like(color0) if env_s else None
    bz_pre = torch.zeros_like(color0) if env_s else None
    for i in range(aux["n_bounce"]):
        dir_in, color_in = direction, color
        march_rec = vis_rec = None
        if static.checkpoint:
            t_rec, enc_rec, vis_rec = aux["rec"][i]
            march_rec = (t_rec, enc_rec)
        with torch.no_grad():
            out = _bounce_state(static, scene, env, origin, dir_in, color_in,
                                alive, pixel_id, i, sample_idx, zc, pz,
                                prev_sky_w=sky_w, march_rec=march_rec,
                                vis_rec=vis_rec)
            applied = (out.hit_applied | out.miss_applied)[:, None]
            sz = out.s == 0.0
            s_safe = torch.where(sz, torch.ones_like(out.s), out.s)
            zeros = torch.zeros_like(out.s)
            # the path product's exact rule, zero factors included: a
            # nonzero factor's derivative is C_path / s when no factor is
            # zero (else 0); the one zero factor's is pnz
            w = (torch.where(applied & ~sz & no_zero, u / s_safe, zeros)
                 + torch.where(applied & sz & one_zero, gp, zeros))
            if env_s:
                # the bank suffix: s_i multiplies every bank after it, so
                # its cotangent gains g * (sum_{k>i} B_k) / s_i (total
                # minus the running prefix, which holds this bounce's own
                # bank, free of s_i); where s_i is the only zero so far the
                # derivative is the bz suffix
                bank_pre = bank_pre + out.bank
                bz_pre = bz_pre + out.bz
                w = (w + torch.where(applied & ~sz,
                                     g * (bank_tot - bank_pre) / s_safe,
                                     zeros)
                     + torch.where(applied & sz & (out.zcount == 1),
                                   g * (bz_tot - bz_pre), zeros))
                # the bank factor's cotangent: the arriving throughput
                w_b = g * integ._where(out.gate, color_in, zeros)
        if sel:
            with torch.enable_grad():
                outs = _local(static, sc, en, out, dir_in, pixel_id, i,
                              sample_idx)
                # a factor that no wanted tensor reaches (a black sky's)
                # takes no part
                pairs = [(o, c) for o, c in zip(outs, (w, w_b) if env_s
                                                else (w,))
                         if o.requires_grad]
                got = (torch.autograd.grad(
                    [o for o, _ in pairs], sel,
                    grad_outputs=[c for _, c in pairs], allow_unused=True)
                    if pairs else ())
            acc = [a if d is None else a + d
                   for a, d in zip(acc, got or (None,) * len(acc))]
        origin, direction, color, alive = (out.origin, out.direction,
                                           out.color, out.alive)
        zc, pz, sky_w = out.zcount, out.pnz, out.sky_w

    it = iter(acc)
    d_params = [next(it) if w else None for w in want]
    # dC/dcolor0 is diagonal: (C_path + banks) / color0
    u_tot = u + g * bank_tot if env_s else u
    dcolor0 = torch.where(torch.abs(color0) > 1e-20, u_tot / color0,
                          torch.zeros_like(color0))
    return d_params, dcolor0


def _local(static: _Static, sc: Scene, en: Environment, out: _BounceOut,
           dir_in, pixel_id, i: int, sample_idx):
    """The bounce's differentiable local factors as functions of the scene
    and environment tensors alone (the ray state, indices, masks and drawn
    directions are the replay's, detached): the throughput factor, and
    under ``cfg.env_sampling`` the gated bank factor."""
    cfg = static.cfg
    mat = scenelib.materials_at(sc, out.index)
    kill_f = (~out.killed).to(mat.albedo.dtype)[:, None]
    s_hit = mat.albedo * mat.emission * kill_f
    s_miss = sky_color(en, dir_in)
    if out.sky_mask is not None:
        s_miss = s_miss * out.sky_mask[:, None]
    s = integ._where(out.hit_applied, s_hit,
                     integ._where(out.miss_applied, s_miss,
                                  torch.ones_like(s_hit)))
    if not cfg.env_sampling:
        return (s,)
    counter = _counter(cfg, sample_idx, i)
    position = torch.zeros_like(dir_in)
    if static.diffuse_only:
        b, _ = integ._nee_env(sc, en, out.index, position, dir_in,
                              out.normal, torch.ones_like(out.gate),
                              mat.albedo, out.gate, pixel_id, counter, cfg,
                              lobe_prob=False, visible_rec=out.vis)
    else:
        b, _ = integ._nee_env(sc, en, out.index, position, dir_in,
                              out.normal, out.outer, mat.albedo, out.gate,
                              pixel_id, counter, cfg,
                              roughness_fresnel=static.roughness_fresnel,
                              reflect_kill=static.reflect_kill,
                              visible_rec=out.vis)
    comp = _nee_comp(cfg, i, b.dtype)
    if comp is not None:
        b = b * comp
    return (s, integ._where(out.gate, b, torch.zeros_like(b)))


def replay_trace(static: _Static, scene: Scene, env: Environment, origin,
                 direction, color0, pixel_id, sample_idx) -> torch.Tensor:
    """The megakernel radiance (N, 3) with the path-replay backward: the
    forward is the early-exit trace, the backward re-simulates the path
    with the same counters and sums each bounce's factor VJPs. Gradients
    reach the scene's float buffers, the environment's tensors and
    ``color0``; ``origin`` and ``direction`` get zeros, as in the
    reference."""
    e_tensors = tuple(getattr(env, k) for k in _env_names(env))
    s_tensors = scenelib.params(scene)
    return _ReplayTrace.apply(static, scene, env, origin, direction, color0,
                              pixel_id, sample_idx, len(s_tensors),
                              *s_tensors, *e_tensors)


def trace_replay(scene: Scene, env: Environment, rays: Rays,
                 pixel_id: torch.Tensor, sample_idx, cfg: RenderConfig,
                 diffuse_only: bool = False, roughness_fresnel: bool = True,
                 restart_at_hit: bool = True,
                 reflect_kill: bool = False) -> torch.Tensor:
    """``megakernel_trace``'s signature subset; returns the (N, 3)
    radiance with path-replay gradients. ``cfg.replay_march_checkpoint``
    None records the march when ``max_raytrace`` bounces of it (t f32 and
    the hit index i32, and the visibility under NEE) fit in 1 GiB."""
    checkpoint = cfg.replay_march_checkpoint
    if checkpoint is None:
        per = 8 + (1 if cfg.env_sampling else 0)
        checkpoint = cfg.max_raytrace * rays.origin.shape[0] * per \
            <= (1 << 30)
    static = _Static(cfg, diffuse_only, roughness_fresnel, restart_at_hit,
                     bool(reflect_kill), bool(checkpoint))
    return replay_trace(static, scene, env, rays.origin, rays.direction,
                        rays.color, pixel_id, sample_idx)
