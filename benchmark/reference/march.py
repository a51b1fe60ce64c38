"""The reference's sphere trace: the lock-step march with per-lane masks
(the over-relaxation rule ``omega/<policy>.py`` and the hit test
``hit/<criterion>.py``; no escape bound), resumable from a carried
``(t, w, s, d)``, and the implicit hit-point gradient that attaches a hit
to the SDF's tensors (a frozen copy of the program's plain
``ops/march.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import base, part, stage
from . import scene as sc


class March(NamedTuple):
    t: torch.Tensor
    index: torch.Tensor
    hit: torch.Tensor
    fin: torch.Tensor   # trips this call: the converging trip, the budget
    #                     if unconverged, 0 if gated off
    w: torch.Tensor
    s: torch.Tensor
    d: torch.Tensor
    done: torch.Tensor  # int32


@base("march")
def march(scene: sc.Scene, origin, direction, rc: dict, budget: int,
          active=None, init=None, chains: bool = True,
          on_trip=None) -> March:
    """At most ``budget`` trips of the march; ``rc``: the render settings
    (``omega``, ``omega_policy``, ``hit_criterion``, ``hit_precision``,
    ``march_t0``, ``max_dis``, ``pixel_radius``). The trips run on the live
    lanes alone, gathered anew whenever at most half of those in work are
    live; ``on_trip(pos, live)``, if given, sees each trip's points and
    live lanes (of the lanes in work). ``chains``: the bunny MLP in the
    march kernels' order; False, with matrix products."""
    omega = part("omega", rc["omega_policy"])
    crit = part("hit", rc["hit_criterion"])
    with torch.no_grad():
        n = origin.shape[0]
        kw = dict(dtype=origin.dtype, device=origin.device)
        full = lambda v: torch.full((n,), v, **kw)
        done = (torch.zeros((n,), dtype=torch.bool, device=origin.device)
                if active is None else ~active)
        if init is not None:
            t, w, s, d = (v.to(origin.dtype) for v in init)
        else:
            t, w, s, d = (full(rc["march_t0"]), full(rc["omega"]),
                          full(0.0), full(sc.MAX_DIS))
        index = torch.zeros((n,), dtype=torch.int32, device=origin.device)
        hit = torch.zeros_like(done)
        fin = torch.where(done, 0, budget).to(torch.int32)
        ids, whole = None, None
        o_w, d_w = origin, direction
        i = 0
        while i < budget:
            n_live = int((~done).sum())
            if n_live == 0:
                break
            if 2 * n_live <= done.shape[0]:
                whole = _write_back(whole, ids,
                                    (t, w, s, d, index, hit, fin, done))
                ids = torch.nonzero(~whole[7]).flatten()
                t, w, s, d, index, hit, fin, done = (v[ids] for v in whole)
                o_w, d_w = origin[ids], direction[ids]
            pos = o_w + t[:, None] * d_w
            if on_trip is not None:
                on_trip(pos, ~done)
            idx_now, dist = sc.nearest(scene, pos, chains)
            rollback, w_next = omega.trip(t, w, s, d, dist, done, rc)
            s_rb = s * (1.0 - w)
            s_fwd = w_next * dist
            hit_now = crit.hit(dist, t, rc)
            live = ~done
            step = torch.where(rollback, s_rb, s_fwd)
            t_new = torch.where(live, t + step, t)
            upd = live & ~rollback
            hit = torch.where(upd, hit_now, hit)
            escaped = t_new >= rc["max_dis"]
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
        return March(t, index, hit, fin, w, s, d, done.to(torch.int32))


def _write_back(whole, ids, work):
    if ids is None:
        return tuple(work)
    return tuple(v.index_copy(0, ids, u) for v, u in zip(whole, work))


class _HitT(torch.autograd.Function):
    """Identity on ``t``; at a hit, ``dt/dtheta = -(df/dtheta) / (df/dt)``
    with ``df/dt = grad_p f . direction``."""

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
            f = sc.sd_object(sc.with_sdf_reads(ctx.scene, leaves), index, p)
            (grad_p,) = torch.autograd.grad(f.sum(), p, retain_graph=any(want))
        dfdt = sc.dot(grad_p, direction)
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


def hit_t(scene: sc.Scene, origin, direction, t, index, hit):
    """``t`` with the implicit hit-point gradients attached."""
    return _HitT.apply(scene, origin, direction, t, index, hit,
                       *sc.sdf_reads(scene))


def march_full(scene, origin, direction, rc: dict, active=None,
               chains: bool = True):
    """The whole budget of ``rc['max_raymarch']`` trips; with autograd
    recording, ``t`` carries :func:`hit_t`. Returns (t, position, index,
    hit)."""
    r = stage(rc, "march")(scene, origin, direction, rc, rc["max_raymarch"],
                           active, chains=chains)
    t = r.t
    if torch.is_grad_enabled():
        t = hit_t(scene, origin, direction, t, r.index, r.hit)
    return t, origin + t[:, None] * direction, r.index, r.hit
