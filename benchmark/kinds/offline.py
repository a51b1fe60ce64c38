"""The ``offline`` traffic: the offline animation renderer's sample passes,
back to back. A unit is one sample pass of the still: the program's
``render_image`` of every pixel at one sample (``spp=1``, untonemapped),
the sample index advancing a pass (the set-up's passes are samples 0, 1,
...; window unit ``i`` is sample ``warmup_units + i``), added to the
frame's accumulator on the card. After each ``spp`` passes the frame's
mean is copied to the host and the accumulator starts again, as the
offline app writes a frame (``apps/offline.render_animation``).

End-to-end: ``msps``, the pixels times the window's passes over its
seconds.

The check: pixels drawn from the seed, and two window passes drawn from
the seed among its first ``check_window_from``. A drawn pass keeps its
colour (read from ``render_image``'s image) and its bounce count (from
the ``megakernel_trace`` call inside it) at those pixels, on the card.
After the window the reference renders the same samples of those pixels
from nothing (a sample depends only on the pixel, its index and the
seed) through its forward megakernel
(``reference/features/forward_megakernel.py``). ``mismatch_pct``: the
share of the checked pixel-passes whose colour or bounce count differs
from the reference's by more than rounding.

The traced run's replay counts the live lanes of each bounce through the
program's own counter (``ops/integrator.LIVE_LANES``, while its spans are
recorded) and puts the first traced pass's into ``ctx.extra``; a program
without the counter gives none.
"""
from __future__ import annotations

import contextlib
import importlib
import types

import numpy as np
import torch

from .. import harness, program
from ..reference import render as ref
from ..reference import stage

FEATURE = "forward_megakernel"


def setup(cell, seed, device, rt, spans, trace):
    tr = cell.traffic
    scene, env, cam, cfg = program.build(cell, seed, device)
    w, h = cfg.width, cfg.height
    ids = harness.check_pixels(seed, w * h, tr["check_pixels"])
    cuda = torch.device(device).type == "cuda"
    ctx = types.SimpleNamespace(
        cell=cell, seed=seed, rt=rt, scene=scene, env=env, cam=cam, cfg=cfg,
        spans=spans, ids=ids, ids_d=ids.to(device),
        flat_d=image_index(ids, w, h).to(device), spp=tr["spp"],
        first=tr["warmup_units"],
        acc=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        host=torch.empty((h, w, 3), dtype=torch.float32, pin_memory=cuda),
        at=set(harness.drawn(seed, 1, tr["check_window_from"],
                             tr["check_window_units"])),
        kept=[], extra={})
    for k in range(ctx.first):
        _pass(ctx, k)
    return ctx


def image_index(ids: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Each pixel id's row in ``render_image``'s (H, W, 3) image read flat:
    the id is x-major (``x * height + y``), the image's row 0 the top."""
    x = torch.div(ids, height, rounding_mode="floor")
    y = torch.remainder(ids, height)
    return (height - 1 - y) * width + x


@contextlib.contextmanager
def _bounces(ids: torch.Tensor):
    """The bounce counts at ``ids`` of each ``megakernel_trace`` call made
    inside, as device tensors in the yielded list: the program's module
    attribute is wrapped for the section, as ``trace.MarchRecorder`` wraps
    the march."""
    integ = importlib.import_module("raytracingpbr_tpu_torch.ops.integrator")
    real, got = integ.megakernel_trace, []

    def keeping(*args, **kw):
        res = real(*args, **kw)
        got.append(res.bounces.index_select(0, ids))
        return res

    integ.megakernel_trace = keeping
    try:
        yield got
    finally:
        integ.megakernel_trace = real


def _pass(ctx, k: int) -> torch.Tensor:
    """Sample pass ``k``: the image, added to the frame's accumulator; the
    frame's mean to the host after its last pass."""
    img = ctx.rt.render_image(ctx.scene, ctx.env, ctx.cam, ctx.cfg, spp=1,
                              sample_offset=k, tonemapped=False)
    ctx.acc += img
    if (k + 1) % ctx.spp == 0:
        ctx.host.copy_(ctx.acc / ctx.spp)
        ctx.acc.zero_()
    return img


def unit(ctx, i, traced):
    k = ctx.first + i
    with ctx.spans.span("bench.pass"):
        if i not in ctx.at:
            _pass(ctx, k)
            return
        with _bounces(ctx.ids_d) as got:
            img = _pass(ctx, k)
        ctx.kept.append((k, img.reshape(-1, 3).index_select(0, ctx.flat_d),
                         got))


def metrics(ctx, units, window_s, times):
    ctx.extra.update(passes=units,
                     pass_ms_median=float(np.median(times) * 1e3))
    return {"msps": ctx.cfg.num_pixels * units / window_s / 1e6}


def replay(ctx, skip, n, recorder):
    """The traced passes again, with the march calls recorded and the
    program's spans on, so that its counter counts each bounce's live
    lanes."""
    integ = importlib.import_module("raytracingpbr_tpu_torch.ops.integrator")
    profiling = importlib.import_module("raytracingpbr_tpu_torch.utils."
                                        "profiling")
    live = getattr(integ, "LIVE_LANES", None)  # None: no counter
    if live is not None:
        live.clear()
    recorder.on = True
    with profiling.recording():
        for k in range(skip, skip + n):
            ctx.rt.render_image(ctx.scene, ctx.env, ctx.cam, ctx.cfg, spp=1,
                                sample_offset=ctx.first + k,
                                tonemapped=False)
    if live:
        ctx.extra["live_lanes"] = {"sample": ctx.first + skip,
                                   "bounces": len(live[0]),
                                   "after_each_bounce": list(live[0])}
        live.clear()
    else:
        ctx.extra["live_lanes"] = "not counted by this program"


def compare(ctx, device):
    obs = [(k, col.cpu(), got[0].cpu() if len(got) == 1 else None)
           for k, col, got in ctx.kept]
    for k in ("kept", "acc", "host", "scene", "env", "cam"):
        setattr(ctx, k, None)
    harness.free(device)
    ctx.extra["checked_samples"] = [k for k, _, _ in obs]
    return compared(ctx.cell, ctx.seed, ctx.ids, obs, device)


def reference_settings(cell, seed, device, dtype=torch.float32):
    """``harness.reference_side`` with the forward megakernel added to the
    settings' features."""
    rs, sky, cam, rc = harness.reference_side(cell, seed, device, dtype)
    return rs, sky, cam, dict(rc, features=tuple(rc["features"])
                              + (FEATURE,))


def reference_pass(rs, sky, cam, ids, s: int, rc: dict,
                   chains: bool = True):
    """The reference's sample ``s`` of the pixels ``ids``: (radiance,
    bounce counts), the camera ray drawn as ``render_image`` draws it."""
    dtype = cam["lookfrom"].dtype
    s = int(s) & ref.MASK
    w, h = rc["resolution"]
    u_cam = ref.uniform4(ids, s, ref.S_CAMERA, rc["seed"], dtype)
    uv = ref.pixel_uv(ids, w, h, u_cam[0], u_cam[1])
    rays = ref.get_ray(cam, uv, u_cam[2], u_cam[3])
    return stage(rc, "megakernel_trace")(rs, sky, rays, ids, s, rc, chains,
                                         with_bounces=True)


def compared(cell, seed, ids: torch.Tensor, obs: list, device) -> dict:
    """``mismatch_pct`` of a run's observations ``obs``: each (sample,
    colour (P, 3), bounce counts (P,) or None where none was kept) at the
    pixels ``ids``, against the reference's render of the same sample.
    With nothing observed it reads 100."""
    if not obs:
        return {"mismatch_pct": 100.0}
    rs, sky, cam, rc = reference_settings(cell, seed, device)
    ids_d = ids.to(device)
    bad, total = 0, 0
    with torch.no_grad():
        for s, col, bnc in obs:
            want_c, want_b = reference_pass(rs, sky, cam, ids_d, s, rc)
            m = ~harness.close(col, want_c)
            m = m | (~harness.close(bnc, want_b) if bnc is not None
                     else torch.ones_like(m))
            bad, total = bad + int(m.sum()), total + m.numel()
    return {"mismatch_pct": 100.0 * bad / total}


def control(cell, seed, device, mode) -> dict:
    """``mismatch_pct`` with the control in the program's place: the drawn
    passes of the sampled pixels rendered by the reference in ``mode``,
    observed as a run observes the program."""
    tr = cell.traffic
    c = harness.Control(mode)
    rs, sky, cam, rc = reference_settings(cell, seed, device, c.dtype)
    w, h = rc["resolution"]
    ids = harness.check_pixels(seed, w * h, tr["check_pixels"])
    ids_d = ids.to(device)
    obs = []
    with c, torch.no_grad():
        for i in sorted(harness.drawn(seed, 1, tr["check_window_from"],
                                      tr["check_window_units"])):
            s = tr["warmup_units"] + i
            col, bnc = reference_pass(rs, sky, cam, ids_d, s, rc, c.chains)
            obs.append((s, col.float().cpu(), bnc.cpu()))
    return compared(cell, seed, ids, obs, device)
