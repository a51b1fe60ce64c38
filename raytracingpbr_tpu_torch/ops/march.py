"""Enhanced sphere tracing (port of ``raytracingpbr_tpu/ops/march.py``).

``march_resumable_plain`` is the plain PyTorch march: the flat batch
advances in lock-step with per-lane masks until every lane has hit or
escaped, or the trip budget is spent; the trips run on the live lanes
alone, gathered anew whenever half of those in work are done. It is the
oracle for the CUDA march kernels (``kernels/march_kernel.py``), and on
the CPU it is the march. Its
``nearest`` evaluates the bunny MLP written out in K1c's order of
operations (about 150 elementwise launches a trip on the card), so the
two agree bit for bit there; with ``cfg.bunny_mxu`` it evaluates the MLP
in the matmul form, the plain version of K1d, which the tensor-core kernel
matches within the bar of :func:`assert_march_close`.

Dispatch follows the tensors: ``march_resumable`` and ``march`` send CUDA
tensors to the kernel and CPU tensors to the plain version. With
``cfg.march_compaction``, ``march`` runs its budget in phases over
repartitioned lanes (``march_phased``, the JAX package's compaction of the
march, a wrapper of ``march_resumable`` with no kernel of its own), with
the same results bit for bit.

Gradients: the march loop is detached (autograd through hundreds of trips
is hopeless), and ``march(differentiable=True)`` re-attaches them at the
hit point through the implicit function theorem: ``dt*/dtheta =
-(df/dtheta) / (df/dt)`` with ``df/dt = grad_p f . direction`` (``_hit_t``,
a ``torch.autograd.Function``). They reach the buffers the SDF reads and
the ray's origin and direction, whichever march found the hit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from ..core.math import dot
from ..kernels import march_kernel
from ..utils.profiling import traced
from . import scene as scenelib
from .compact import actives_first_perm
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
                active=None, init=None, on_trip=None) -> ResumableResult:
    """The lock-step march. Inactive lanes start done (``fin`` 0, ``index``
    0, ``hit`` False) and echo their init ``(t, w, s, d)``; the wavefront's
    split carry relies on that. ``on_trip(pos, live)``, if given, sees
    each trip's points and live lanes (work accounting,
    ``utils/speedlight``).

    Without ``on_trip`` the trips run on the live lanes alone: whenever at
    most half of the lanes in work are live, the loop writes them back and
    gathers the live ones. Every lane's arithmetic is the same either way;
    only the lanes that a trip computes and then discards change."""
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

    bound2 = scenelib.escape_bound2(scene, cfg)
    # the lanes in work (None: all) and the whole batch's state, written
    # back when the lanes in work change
    ids, whole = None, None
    o_w, d_w = origin, direction

    i = 0
    while i < cfg.max_raymarch:
        n_live = int((~done).sum())
        if n_live == 0:
            break
        if on_trip is None and 2 * n_live <= done.shape[0]:
            whole = _write_back(whole, ids, (t, w, s, d, index, hit, fin,
                                             done))
            ids = torch.nonzero(~whole[7]).flatten()
            t, w, s, d, index, hit, fin, done = (v[ids] for v in whole)
            o_w, d_w = origin[ids], direction[ids]
        pos = o_w + t[:, None] * d_w
        if on_trip is not None:
            on_trip(pos, ~done)
        idx_now, dist = scenelib.nearest(scene, pos,
                                         kernel_order=not cfg.bunny_mxu)

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
                                 & (dot(pos, d_w) > 0.0))
        done_new = done | (upd & (hit_now | escaped))

        t = t_new
        w = torch.where(live, w_next, w)
        s = torch.where(live, step, s)
        d = torch.where(live, dist, d)
        index = torch.where(live, idx_now, index)
        fin = torch.where(live & done_new, i + 1, fin)
        done = done_new
        i += 1
    t, w, s, d, index, hit, fin, done = _write_back(
        whole, ids, (t, w, s, d, index, hit, fin, done))
    return ResumableResult(t, index, hit, fin, w, s, d, done.to(torch.int32))


def _write_back(whole, ids, work):
    """The whole batch's state with the lanes in work (``ids``; None: all
    of them) replaced by ``work``."""
    if ids is None:
        return tuple(work)
    return tuple(v.index_copy(0, ids, u) for v, u in zip(whole, work))


def march_resumable_plain(scene: Scene, origin: torch.Tensor,
                          direction: torch.Tensor, cfg: RenderConfig,
                          active: Optional[torch.Tensor] = None,
                          init=None, on_trip=None) -> ResumableResult:
    """Plain PyTorch budget-capped march on any device: the oracle of the
    CUDA kernels. Same contract as :func:`march_resumable`; ``on_trip`` as
    in :func:`_march_loop`."""
    with torch.no_grad():
        return _march_loop(scene, origin, direction, cfg, active, init,
                           on_trip)


def assert_march_close(scene: Scene, origin: torch.Tensor,
                       direction: torch.Tensor, k: ResumableResult,
                       p: ResumableResult, cfg: RenderConfig):
    """K1d's bar against its plain version (the matmul-form march) on the
    same rays, on the reference's march bars (``tests/test_pallas.py:45-52``):
    - at least 99.9% of lanes agree on hit;
    - the index is equal wherever both hit;
    - where hit agrees, ``t`` is within rtol and atol 1e-3, save
      - lanes excused: both hit within ``max(omega, 1)`` hit tolerances of
        each other (``t * pixel_radius`` for RELATIVE and CONE,
        ``hit_precision`` for ABSOLUTE), the two f32 evaluations of the
        MLP putting the hit one trip apart; or both missed and have left
        the scene, past ``cfg.max_dis`` or outside its bounding sphere and
        moving away (the escape bound's test, whether ``cfg`` runs it or
        not): nothing is left to hit, and the march's steps grow with t,
        so a difference from the MLP grows with it;
      - grazing lanes, at most one in 10,000 (``n // 10000``): a lane that
        passes a surface at about the hit threshold is sent on different
        paths by the two evaluations (a hit there or on a farther
        surface), as a hit lane is sent apart from a miss lane on the 0.1%
        the first bar allows.
    Raises AssertionError.

    Returns ``(max |dt| over the lanes held to the tolerance, lanes
    excused, lanes disagreeing on hit, (N,) bool mask of the grazing lanes
    apart in t)``."""
    n = k.t.numel()
    same = k.hit == p.hit
    both = k.hit & p.hit
    dt = (k.t - p.t).abs()
    close = torch.isclose(k.t, p.t, rtol=1e-3, atol=1e-3)
    if cfg.hit_criterion == HitCriterion.ABSOLUTE:
        tol = torch.full_like(dt, cfg.hit_precision)
    else:
        tol = torch.maximum(k.t, p.t) * cfg.pixel_radius
    one_trip = both & (dt <= max(cfg.omega, 1.0) * tol)
    bound2 = scenelib.escape_bound2(scene, cfg.replace(escape_bound=True))

    def left(t):
        out = t >= cfg.max_dis
        if bound2 is not None:
            pos = origin + t[:, None] * direction
            out = out | ((dot(pos, pos) > bound2)
                         & (dot(pos, direction) > 0.0))
        return out

    gone = ~k.hit & ~p.hit & left(k.t) & left(p.t)
    excused = ~close & (gone | one_trip)
    apart = same & ~close & ~excused
    split = int((~same).sum())
    index_bad = int((k.index != p.index)[both].sum())
    if split * 1000 > n or int(apart.sum()) > n // 10000 or index_bad:
        lanes = torch.nonzero(apart).flatten()[:8].tolist()
        raise AssertionError(
            f"march bar: {split} of {n} lanes disagree on hit (at most "
            f"0.1%); {int(apart.sum())} agreeing lanes apart in t (at most "
            f"{n // 10000}), first {lanes}: t {k.t[lanes].tolist()} vs "
            f"{p.t[lanes].tolist()}, hit {k.hit[lanes].tolist()}, done "
            f"{k.done[lanes].tolist()} vs {p.done[lanes].tolist()}; "
            f"{index_bad} index mismatches where both hit")
    held = same & close
    err = float(dt[held].max()) if bool(held.any()) else 0.0
    return err, int(excused.sum()), split, apart


@traced("march")
def march_resumable(scene: Scene, origin: torch.Tensor,
                    direction: torch.Tensor, cfg: RenderConfig,
                    active: Optional[torch.Tensor] = None,
                    init=None) -> ResumableResult:
    """Budget-capped march exposing the full resumable loop state.

    ``cfg.max_raymarch`` is this call's trip budget; ``init`` an optional
    ``(t, w, s, d)`` tuple of (N,) tensors from a prior call. Per lane, the
    trips of chained calls are bit-identical to one uninterrupted march.
    CUDA tensors go through the hand-written kernel, CPU tensors through
    the plain version. Detached: callers attach :func:`_hit_t` where a
    segment completes."""
    with torch.no_grad():
        if origin.is_cuda:
            return ResumableResult(*march_kernel.march_resumable_cuda(
                scene, origin, direction, cfg, active=active, init=init))
        return march_resumable_plain(scene, origin, direction, cfg, active,
                                     init)


def resolve_phases(cfg: RenderConfig) -> Tuple[int, ...]:
    """Trip budgets of the phased march, in order; they sum to
    ``cfg.max_raymarch``. ``cfg.march_phases`` wins when set (ValueError
    unless positive and summing to the budget). Otherwise a budget of at
    most ``max(64, 2 * chunk)`` runs in one phase, and a longer one in
    phases of 32, 32, then doubling, each capped by what is left (512:
    32 + 32 + 64 + 128 + 256; 2048: ... + 512 + 1024). ``chunk`` is
    ``cfg.march_chunk`` or 1; the budgets are rounded up to its multiples,
    as the JAX package rounds them (the port's kernels have no chunk, so
    it shapes only the split)."""
    if cfg.march_phases is not None:
        ps = tuple(int(b) for b in cfg.march_phases)
        if sum(ps) != cfg.max_raymarch or any(b <= 0 for b in ps):
            raise ValueError(
                f"march_phases={cfg.march_phases} must be positive and sum "
                f"to max_raymarch={cfg.max_raymarch}")
        return ps
    m = cfg.max_raymarch
    q = cfg.march_chunk if cfg.march_chunk else 1

    def up(b):
        return -(-b // q) * q

    if m <= max(64, 2 * q):
        return (m,)
    phases, nxt = [], up(32)
    while sum(phases) < m:
        phases.append(min(nxt, m - sum(phases)))
        if len(phases) >= 2:
            nxt = up(nxt * 2)
    return tuple(phases)


def march_phased(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
                 cfg: RenderConfig, active: Optional[torch.Tensor] = None,
                 init=None, counts: Optional[torch.Tensor] = None
                 ) -> ResumableResult:
    """The compacted march (``cfg.march_compaction``): the budget of
    ``cfg.max_raymarch`` trips runs in the phases of :func:`resolve_phases`.
    Each phase marches every lane still going a phase's budget through
    :func:`march_resumable` (the kernels on the card, the plain march on
    the CPU), resumed from the carried ``(t, w, s, d)`` with the ``active``
    gate; between phases a stable counting partition
    (``ops/compact.actives_first_perm``) moves the lanes still going to the
    front, so that a warp holds lanes that still march. Per lane the trips are
    those of one uninterrupted march, so all eight outputs equal
    :func:`march_resumable`'s bit for bit: ``fin`` is summed over the
    phases, a lane done at a phase's entry keeps its ``index`` and
    ``hit``, and the results return to the callers' lane order by one
    inverse scatter. Every phase launches over the whole batch (the lanes
    done wait at the back); nothing here asks the card for a count.
    ``init`` as in :func:`march_resumable`; ``counts``, for the work
    accounting only (``utils/speedlight``), is passed to each phase's
    K1c/K1d launch."""
    phases = resolve_phases(cfg)
    n = origin.shape[0]
    dev = origin.device
    with torch.no_grad():
        if init is None:
            init = tuple(torch.full((n,), v, dtype=origin.dtype, device=dev)
                         for v in (cfg.march_t0, cfg.omega, 0.0,
                                   scenelib.MAX_DIS))
        t, w, s, d = init
        done = (torch.zeros((n,), dtype=torch.int32, device=dev)
                if active is None else (~active).to(torch.int32))
        order = torch.arange(n, device=dev)  # lane position -> ray id
        index = torch.zeros((n,), dtype=torch.int32, device=dev)
        hit = torch.zeros((n,), dtype=torch.bool, device=dev)
        fin = torch.zeros((n,), dtype=torch.int32, device=dev)
        o_cur, d_cur = origin, direction
        for k, budget in enumerate(phases):
            if k > 0:
                perm = actives_first_perm(done == 0)
                order, t, w, s, d, index, hit, fin, done = (
                    v.index_select(0, perm)
                    for v in (order, t, w, s, d, index, hit, fin, done))
                o_cur = origin.index_select(0, order)
                d_cur = direction.index_select(0, order)
            going = done == 0
            pcfg = cfg.replace(max_raymarch=budget)
            if counts is not None:
                rr = ResumableResult(*march_kernel.march_resumable_cuda(
                    scene, o_cur, d_cur, pcfg, active=going,
                    init=(t, w, s, d), counts=counts))
            else:
                rr = march_resumable(scene, o_cur, d_cur, pcfg,
                                     active=going, init=(t, w, s, d))
            # lanes done at entry echo their (t, w, s, d) and come out with
            # index 0, hit False, fin 0: they keep what they had
            t, w, s, d, done = rr.t, rr.w, rr.s, rr.d, rr.done
            index = torch.where(going, rr.index, index)
            hit = torch.where(going, rr.hit, hit)
            fin = fin + rr.fin
        out = (t, index, hit, fin, w, s, d, done)
        return ResumableResult(*(torch.empty_like(v).index_copy_(0, order, v)
                                 for v in out))


class _HitT(torch.autograd.Function):
    """Identity on ``t`` with implicit-function gradients at the hit point
    (the JAX package's ``custom_vjp``). The buffers the signed distance
    reads come in as the flat tensor arguments ``params``
    (``scene.sdf_params``' order), since only tensor arguments get
    gradients; ``scene`` gives the metadata to rebuild it in the backward.
    The materials are left out: they take no gradient here, and passing
    them would record this node (and the second-order normal after it)
    whenever only a material requires grad."""

    @staticmethod
    def forward(ctx, scene, origin, direction, t, index, hit, *params):
        ctx.scene = scene
        ctx.save_for_backward(origin, direction, t, index, hit, *params)
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        origin, direction, t, index, hit, *params = ctx.saved_tensors
        want = ctx.needs_input_grad[6:]
        with torch.enable_grad():
            leaves = [v.detach().requires_grad_(w)
                      for v, w in zip(params, want)]
            p = (origin + t[:, None] * direction).detach().requires_grad_(True)
            f = scenelib.sd_object(
                scenelib.with_sdf_params(ctx.scene, leaves), index, p)
            (grad_p,) = torch.autograd.grad(f.sum(), p, retain_graph=any(want))
        dfdt = dot(grad_p, direction)
        # a valid hit has |df/dt| bounded away from 0 unless it grazes
        safe = torch.where(torch.abs(dfdt) > 1e-6, dfdt,
                           torch.sign(dfdt) * 1e-6 + 1e-12)
        coeff = torch.where(hit, -g / safe, torch.zeros_like(g))
        d_params = [None] * len(params)
        if any(want):
            sel = [v for v, w in zip(leaves, want) if w]
            got = iter(torch.autograd.grad(f, sel, grad_outputs=coeff,
                                           allow_unused=True))
            d_params = [next(got) if w else None for w in want]
        d_origin = coeff[:, None] * grad_p
        d_direction = (coeff * t)[:, None] * grad_p
        return (None, d_origin, d_direction, None, None, None, *d_params)


def _hit_t(scene: Scene, origin, direction, t, index, hit) -> torch.Tensor:
    """``t`` with gradients to the SDF's buffers, ``origin`` and
    ``direction`` through the implicit hit-point relation: for a hit lane
    ``sdf(theta, origin + t* direction) = 0``, so ``dt*/dtheta =
    -(df/dtheta) / (df/dt)`` with ``df/dt = grad_p f . direction`` (guarded
    to ``sign * 1e-6 + 1e-12`` where ``|df/dt| <= 1e-6``). Miss lanes get
    zero gradient, and ``t`` itself none."""
    return _HitT.apply(scene, origin, direction, t, index, hit,
                       *scenelib.sdf_params(scene))


def march(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
          cfg: RenderConfig, differentiable: bool = True,
          active: Optional[torch.Tensor] = None) -> MarchResult:
    """Sphere-trace a flat ray batch with the full ``cfg.max_raymarch``
    budget (in the phases of :func:`march_phased` when
    ``cfg.march_compaction``, with the same results). ``active``: optional
    (N,) bool gate; inactive lanes' outputs are their inits and must be
    ignored. When ``differentiable`` (the default,
    as in the reference) and autograd records, ``t`` and the position carry
    :func:`_hit_t`'s gradients; the loop itself is detached either way."""
    impl = march_phased if cfg.march_compaction else march_resumable
    rr = impl(scene, origin, direction, cfg, active=active)
    iters = (torch.amax(rr.fin) if rr.fin.numel()
             else torch.zeros((), dtype=torch.int32, device=origin.device))
    t = rr.t
    if differentiable and torch.is_grad_enabled():
        t = _hit_t(scene, origin, direction, t, rr.index, rr.hit)
    return MarchResult(t, origin + t[:, None] * direction, rr.index,
                       rr.hit, iters)
