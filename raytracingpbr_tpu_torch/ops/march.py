"""Enhanced sphere tracing (port of ``raytracingpbr_tpu/ops/march.py``).

``march_resumable_plain`` is the plain PyTorch march: the whole flat batch
advances in lock-step with per-lane masks until every lane has hit or
escaped, or the trip budget is spent. It is the oracle for the CUDA march
kernel (``kernels/march_kernel.py``), and on the CPU it is the march.

Dispatch follows the tensors: ``march_resumable`` and ``march`` send CUDA
tensors to the kernel and CPU tensors to the plain version.

Gradients (``_hit_t``, the implicit hit-point VJP) are not ported yet:
``march(differentiable=True)`` raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from ..core.math import dot
from ..kernels import march_kernel
from . import scene as scenelib
from .scene import Scene


class MarchResult(NamedTuple):
    t: torch.Tensor         # (N,) hit parameter along the ray
    position: torch.Tensor  # (N, 3) origin + t * direction
    index: torch.Tensor     # (N,) i32 nearest-object index
    hit: torch.Tensor       # (N,) bool
    iters: torch.Tensor     # () i32 trips of the longest lane


class ResumableResult(NamedTuple):
    """Full per-lane march loop state."""
    t: torch.Tensor      # (N,) f32
    index: torch.Tensor  # (N,) i32
    hit: torch.Tensor    # (N,) bool
    fin: torch.Tensor    # (N,) i32 trips this call: 1-based trip of
    #                      convergence, the budget if unconverged, 0 if
    #                      gated inactive
    w: torch.Tensor      # (N,) f32 over-relaxation state
    s: torch.Tensor      # (N,) f32 last step
    d: torch.Tensor      # (N,) f32 last distance
    done: torch.Tensor   # (N,) i32 1 if hit/escaped or gated inactive


def _march_loop(scene: Scene, origin, direction, cfg: RenderConfig,
                active=None, init=None) -> ResumableResult:
    """The lock-step march. Inactive lanes start done (``fin`` 0, ``index``
    0, ``hit`` False) and echo their init ``(t, w, s, d)``; the wavefront's
    split carry relies on that."""
    n = origin.shape[0]
    kw = dict(dtype=origin.dtype, device=origin.device)
    full = lambda v: torch.full((n,), v, **kw)
    done = (torch.zeros((n,), dtype=torch.bool, device=origin.device)
            if active is None else ~active)
    if init is not None:
        t, w, s, d = (v.to(origin.dtype) for v in init)
    else:
        t, w, s, d = (full(cfg.march_t0), full(cfg.omega), full(0.0),
                      full(scenelib.MAX_DIS))
    index = torch.zeros((n,), dtype=torch.int32, device=origin.device)
    hit = torch.zeros_like(done)
    fin = torch.where(done, 0, cfg.max_raymarch).to(torch.int32)

    bound2 = None
    if cfg.escape_bound:
        bound = scenelib.bounding_radius(scene)
        if bound is not None:
            bound2 = bound * bound

    i = 0
    while i < cfg.max_raymarch and not bool(done.all()):
        pos = origin + t[:, None] * direction
        idx_now, dist = scenelib.nearest(scene, pos)

        if cfg.omega_policy == OmegaPolicy.CONSTANT:
            rollback = torch.zeros_like(done)
            w_next = w
        else:
            # relative epsilon: exactly touching bounds (d + dist == s)
            # must roll back or the ray tunnels (see the JAX loop)
            rollback = d + dist < s * (1.0 + 1e-6)
            if cfg.omega_policy == OmegaPolicy.ROLLBACK_TO_ONE:
                rollback = rollback & (w > 1.0)
                w_next = torch.where(rollback, 1.0, w)
            else:  # ROLLBACK_HALF_UP
                w_next = torch.where(rollback, 0.5 + 0.5 * w, w)

        s_rb = s * (1.0 - w)
        s_fwd = w_next * dist

        if cfg.hit_criterion == HitCriterion.CONE:
            hit_now = dist < (t + s_fwd) * cfg.pixel_radius
        elif cfg.hit_criterion == HitCriterion.RELATIVE:
            hit_now = dist / torch.clamp_min(t, 1e-12) < cfg.pixel_radius
        else:  # ABSOLUTE
            hit_now = dist < cfg.hit_precision

        live = ~done
        step = torch.where(rollback, s_rb, s_fwd)
        t_new = torch.where(live, t + step, t)
        upd = live & ~rollback
        hit = torch.where(upd, hit_now, hit)
        escaped = t_new >= cfg.max_dis
        if bound2 is not None:
            escaped = escaped | ((dot(pos, pos) > bound2)
                                 & (dot(pos, direction) > 0.0))
        done_new = done | (upd & (hit_now | escaped))

        t = t_new
        w = torch.where(live, w_next, w)
        s = torch.where(live, step, s)
        d = torch.where(live, dist, d)
        index = torch.where(live, idx_now, index)
        fin = torch.where(live & done_new, i + 1, fin)
        done = done_new
        i += 1
    return ResumableResult(t, index, hit, fin, w, s, d, done.to(torch.int32))


def march_resumable_plain(scene: Scene, origin: torch.Tensor,
                          direction: torch.Tensor, cfg: RenderConfig,
                          active: Optional[torch.Tensor] = None,
                          init=None) -> ResumableResult:
    """Plain PyTorch budget-capped march on any device: the oracle of the
    CUDA kernel. Same contract as :func:`march_resumable`."""
    with torch.no_grad():
        return _march_loop(scene, origin, direction, cfg, active, init)


def march_resumable(scene: Scene, origin: torch.Tensor,
                    direction: torch.Tensor, cfg: RenderConfig,
                    active: Optional[torch.Tensor] = None,
                    init=None) -> ResumableResult:
    """Budget-capped march exposing the full resumable loop state.

    ``cfg.max_raymarch`` is this call's trip budget; ``init`` an optional
    ``(t, w, s, d)`` tuple of (N,) tensors from a prior call. Per lane, the
    trips of chained calls are bit-identical to one uninterrupted march.
    CUDA tensors go through the hand-written kernel, CPU tensors through
    the plain version. Forward only."""
    if origin.is_cuda:
        return ResumableResult(*march_kernel.march_resumable_cuda(
            scene, origin, direction, cfg, active=active, init=init))
    return march_resumable_plain(scene, origin, direction, cfg, active, init)


def march(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
          cfg: RenderConfig, differentiable: bool = False,
          active: Optional[torch.Tensor] = None) -> MarchResult:
    """Sphere-trace a flat ray batch with the full ``cfg.max_raymarch``
    budget. ``active``: optional (N,) bool gate; inactive lanes' outputs are
    their inits and must be ignored."""
    if differentiable:
        raise NotImplementedError(
            "march gradients (_hit_t) are not ported yet")
    rr = march_resumable(scene, origin, direction, cfg, active=active)
    iters = (torch.amax(rr.fin) if rr.fin.numel()
             else torch.zeros((), dtype=torch.int32, device=origin.device))
    return MarchResult(rr.t, origin + rr.t[:, None] * direction, rr.index,
                       rr.hit, iters)
