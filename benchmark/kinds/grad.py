"""The ``grad`` traffic: back-to-back fwd+bwd steps of inverse rendering. A
unit is one step: ``render_pixels`` of every pixel at the traffic's
``spp`` (scan-AD), the sample offset advancing a step, the mean squared
difference from a target image drawn from the seed, and
``torch.autograd.grad`` of the configuration's ``grad_leaves``.

End-to-end: ``step_ms``, the window's seconds over its steps (the window
ends in a synchronise).

The check: steps of the window drawn from the seed, recomputed whole by
the reference: ``loss_gap``, the loss's gap relative to the reference's,
and ``grad_gap``, the worst leaf's gap in norm over the larger of its
reference norm and the median leaf's. An entry that is not finite has to
be so on both sides, alike.
"""
from __future__ import annotations

import math
import types

import numpy as np
import torch

from .. import harness, program
from ..reference import render as ref


def target_image(seed: int, n: int, device) -> torch.Tensor:
    """The (N, 3) target image of a grad run, uniform in [0, 1), drawn
    from the seed on the device."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand((n, 3), generator=g, device=device)


def setup(cell, seed, device, rt, spans, trace):
    tr = cell.traffic
    scene, env, cam, cfg = program.build(cell, seed, device)
    names = cell.config["grad_leaves"]
    make, leaves = program.grad_leaves(scene, names)
    n = cfg.num_pixels
    ctx = types.SimpleNamespace(
        cell=cell, seed=seed, device=device, rt=rt, env=env, cam=cam,
        cfg=cfg, spans=spans, names=names, make=make, leaves=leaves,
        pid=torch.arange(n, dtype=torch.int64, device=device),
        target=target_image(seed, n, device), spp=tr["spp"],
        first=1 + tr["warmup_steps"], done=[], extra={})
    for s in range(ctx.first):
        _step(ctx, s)
    return ctx


def _step(ctx, s: int, traced: bool = False):
    sp = ctx.spans
    with sp.span("bench.step"):
        with sp.span("bench.forward"):
            img = ctx.rt.render_pixels(ctx.make(ctx.leaves), ctx.env,
                                       ctx.cam, ctx.pid, ctx.cfg, ctx.spp,
                                       sample_offset=s * ctx.spp,
                                       differentiable=True)
            loss = torch.mean((img - ctx.target) ** 2)
        if traced:
            harness.sync(ctx.device)
        with sp.span("bench.backward"):
            grads = torch.autograd.grad(loss, [ctx.leaves[k]
                                               for k in ctx.names])
            if traced:
                harness.sync(ctx.device)
    return loss.detach(), grads


def unit(ctx, i, traced):
    s = ctx.first + i
    loss, grads = _step(ctx, s, traced)
    ctx.done.append((s, loss, grads))


def metrics(ctx, units, window_s, times):
    ctx.extra["steps"] = units
    return {"step_ms": window_s / units * 1e3}


def replay(ctx, skip, n, recorder):
    recorder.on = True
    for k in range(skip, skip + n):
        _step(ctx, ctx.first + k)


def compare(ctx, device):
    j = harness.drawn(ctx.seed, 2, len(ctx.done),
                      ctx.cell.traffic["check_window_steps"])
    checked = [(ctx.done[k][0], float(ctx.done[k][1]),
                {nm: g.detach().float().cpu()
                 for nm, g in zip(ctx.names, ctx.done[k][2])}) for k in j]
    target = ctx.target
    for k in ("done", "make", "leaves", "env", "cam"):
        setattr(ctx, k, None)
    harness.free(device)
    worst = {}
    nonfinite = lambda gs: sum(int((~torch.isfinite(g)).sum())
                               for g in gs.values())
    ctx.extra.update(checked_samples=[], nonfinite_grad_entries=[],
                     nonfinite_reference_entries=[])
    for s, loss_p, grads_p in checked:
        loss_r, grads_r = reference_step(ctx.cell, ctx.seed, s, target,
                                         device)
        got = grad_compared(loss_p, grads_p, loss_r, grads_r)
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in got.items()}
        ctx.extra["checked_samples"].append(s)
        ctx.extra["nonfinite_grad_entries"].append(nonfinite(grads_p))
        ctx.extra["nonfinite_reference_entries"].append(nonfinite(grads_r))
    return worst


def reference_step(cell, seed: int, s: int, target, device,
                   dtype=torch.float32, chains: bool = True):
    """The reference's loss and gradients (by leaf name) of the fwd+bwd
    step at sample ``s``, every pixel."""
    rs, sky, cam, rc = harness.reference_side(cell, seed, device, dtype)
    names = cell.config["grad_leaves"]
    src = rs.leaves()
    leaves = {k: src[k].detach().clone().requires_grad_(True) for k in names}
    rs = rs.with_leaves(leaves)
    pid = torch.arange(rc["num_pixels"], dtype=torch.int64, device=device)
    spp = cell.traffic["spp"]
    img = ref.render_pixels(rs, sky, cam, pid, rc, spp, s * spp, chains)
    loss = torch.mean((img - target.to(img.dtype)) ** 2)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return float(loss.detach()), {k: g.detach().float()
                                  for k, g in zip(names, grads)}


def _unlike(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` is not finite anywhere ``b`` is finite, or differs
    from ``b`` where ``b`` is not (NaN where NaN, the same infinity)."""
    fb = torch.isfinite(b)
    return bool((~torch.isfinite(a) & fb).any()
                | (a.isnan() != b.isnan()).any()
                | (b.isinf() & (a != b)).any())


def grad_compared(loss_p: float, grads_p: dict, loss_r: float,
                  grads_r: dict) -> dict:
    """``loss_gap``: |loss - reference's| over the reference's;
    ``grad_gap``: the worst leaf's ``|g - g_ref|`` (Frobenius norm) over
    the larger of that leaf's reference norm and the median leaf's, over
    the entries the reference has finite. An entry, or the loss, that is
    not finite on one side and is not the same on the other reads
    infinity."""
    parts, unlike = {}, False
    for k, b in grads_r.items():
        a, b = grads_p[k].to(b.device).double(), b.double()
        unlike = unlike or _unlike(a, b)
        ok = torch.isfinite(b)
        parts[k] = (a[ok], b[ok])
    norms = {k: float(torch.linalg.vector_norm(b))
             for k, (_, b) in parts.items()}
    med = float(np.median(list(norms.values())))
    gap = max(float(torch.linalg.vector_norm(a - b))
              / max(norms[k], med, 1e-30) for k, (a, b) in parts.items())
    lp, lr = torch.tensor(loss_p), torch.tensor(loss_r)
    if _unlike(lp, lr):
        loss = math.inf
    elif not math.isfinite(loss_r):
        loss = 0.0
    else:
        loss = abs(loss_p - loss_r) / max(abs(loss_r), 1e-30)
    return {"loss_gap": loss if math.isfinite(loss) else math.inf,
            "grad_gap": math.inf if unlike or not math.isfinite(gap)
            else gap}


def control(cell, seed, device, mode) -> dict:
    """``loss_gap`` and ``grad_gap`` with the control in the program's
    place, at the window's first sample."""
    s = 1 + cell.traffic["warmup_steps"]
    w, h = cell.render()["resolution"]
    target = target_image(seed, w * h, device)
    c = harness.Control(mode)
    with c:
        loss_c, grads_c = reference_step(cell, seed, s, target, device,
                                         c.dtype, c.chains)
    loss_r, grads_r = reference_step(cell, seed, s, target, device)
    return grad_compared(loss_c, grads_c, loss_r, grads_r)
