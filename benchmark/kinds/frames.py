"""The ``frames`` traffic: a closed loop of one progressive viewer. A unit is
one ``render_frame`` call of the program (the configuration's
``samples_per_frame`` wavefront steps) and then the frame's displayed
pixels copied to the host, before the next frame starts.

End-to-end: ``msps``, the samples completed in the window (the growth of
the accumulator's count, summed in float64) over its seconds;
``frame_ms_p95``, the 95th percentile of the window's frame times.

The check: pixels drawn from the seed. The reference renders them from a
fresh state, with nothing of the program's in between, through the set-up
frames and on through the window frames drawn from the seed among its
first ``check_window_from``, and is compared at the end of set-up and at
each drawn frame; and it renders the window's last frame from the
program's state before it (a pixel's history is its own, since the RNG is
keyed on pixel, step and seed, but replaying a whole window would cost
more than the window). ``mismatch_pct``: the share of those pixel-frames
whose state or displayed pixels differ from the reference's.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from .. import harness, program
from ..reference import render as ref


def _gather(state, ids: torch.Tensor) -> dict:
    """The sampled pixels' fields of the program's frame state."""
    r = state.rays
    src = {"origin": r.origin, "direction": r.direction, "color": r.color,
           "depth": r.depth, "accum": state.accum, "pixels": state.pixels,
           "respawn": state.respawn, "hit_t": state.hit_t,
           "march_state": state.march_state, "march_cum": state.march_cum}
    return {k: v.index_select(0, ids).cpu() for k, v in src.items()}


def setup(cell, seed, device, rt, spans, trace):
    tr = cell.traffic
    scene, env, cam, cfg = program.build(cell, seed, device)
    n = cfg.num_pixels
    ids = harness.check_pixels(seed, n, tr["check_pixels"])
    cuda = torch.device(device).type == "cuda"
    ctx = types.SimpleNamespace(
        cell=cell, seed=seed, rt=rt, scene=scene, env=env, cam=cam,
        cfg=cfg, spans=spans, trace=trace, ids=ids, ids_d=ids.to(device),
        ids_np=ids.numpy(),
        host=torch.empty((n, 3), dtype=torch.float32, pin_memory=cuda),
        setup_frames=1 + tr["warmup_frames"], held=None, extra={})
    ctx.state = rt.make_frame_state(n, device=device)
    for _ in range(ctx.setup_frames):
        px, ctx.state = rt.render_frame(scene, env, cam, ctx.state, cfg)
        ctx.host.copy_(px)
    ctx.at = set(harness.drawn(seed, 1, tr["check_window_from"],
                               tr["check_window_frames"]))
    ctx.chain = [(ctx.setup_frames - 1, _gather(ctx.state, ctx.ids_d),
                  _shown(ctx))]
    ctx.prev = ctx.state
    ctx.count0 = harness.sample_count(ctx.state.accum)
    return ctx


def _shown(ctx) -> np.ndarray:
    return ctx.host.numpy()[ctx.ids_np].copy()


def unit(ctx, i, traced):
    if ctx.trace and i == 0:
        # the window's first state, held from the start so that the
        # allocator settles around it: the profiled frames' march calls
        # are recorded from it again after the window
        ctx.held = ctx.state
    ctx.prev = ctx.state
    with ctx.spans.span("bench.frame"):
        px, ctx.state = ctx.rt.render_frame(ctx.scene, ctx.env, ctx.cam,
                                            ctx.prev, ctx.cfg)
    with ctx.spans.span("bench.display"):
        ctx.host.copy_(px)
    if i in ctx.at:
        ctx.chain.append((ctx.setup_frames + i,
                          _gather(ctx.state, ctx.ids_d), _shown(ctx)))
    ctx.units = i + 1


def metrics(ctx, units, window_s, times):
    samples = harness.sample_count(ctx.state.accum) - ctx.count0
    ctx.extra.update(frames=units, samples=samples,
                     frame_ms_median=float(np.median(times) * 1e3))
    return {"msps": samples / window_s / 1e6,
            "frame_ms_p95": float(np.percentile(np.array(times) * 1e3, 95))}


def replay(ctx, skip, n, recorder):
    st = ctx.held
    for k in range(skip + n):
        recorder.on = k >= skip
        _, st = ctx.rt.render_frame(ctx.scene, ctx.env, ctx.cam, st, ctx.cfg)
    ctx.held = None


def compare(ctx, device):
    last = ctx.setup_frames + ctx.units - 1
    post = _gather(ctx.state, ctx.ids_d)
    obs = {"ids": ctx.ids, "chain": list(ctx.chain), "replay": []}
    if last > max(f for f, _, _ in obs["chain"]):
        obs["replay"].append((last, _gather(ctx.prev, ctx.ids_d), post,
                              _shown(ctx)))
    elif last not in {f for f, _, _ in obs["chain"]}:
        obs["chain"].append((last, post, _shown(ctx)))
    for k in ("state", "prev", "scene", "host", "env", "cam"):
        setattr(ctx, k, None)
    harness.free(device)
    return compared(ctx.cell, ctx.seed, obs, device)


def frame_mismatch(ref_st: dict, got: dict, shown: np.ndarray
                   ) -> torch.Tensor:
    """(P,) bool: the pixels whose state (every field of
    ``reference.render.STATE_FIELDS``) or displayed pixels differ from the
    reference's."""
    bad = torch.zeros(ref_st["accum"].shape[0], dtype=torch.bool,
                      device=ref_st["accum"].device)
    for k in ref.STATE_FIELDS:
        bad |= ~harness.close(got[k], ref_st[k])
    shown_t = torch.as_tensor(shown, device=bad.device)
    bad |= ~harness.close(shown_t, ref_st["pixels"].float())
    return bad


def compared(cell, seed, obs: dict, device) -> dict:
    """``mismatch_pct`` of a run's observations ``obs``: the sampled pixel
    ids, ``chain`` (each (frame, state after it, displayed pixels) that the
    reference's own chain of frames from a fresh state is held to) and
    ``replay`` (each (frame, state before it, state after it, displayed
    pixels) that the reference renders from the state before it)."""
    rs, sky, cam, rc = harness.reference_side(cell, seed, device)
    ids = obs["ids"].to(device)
    at = {f: (post, shown) for f, post, shown in obs["chain"]}
    bad, total = 0, 0
    with torch.no_grad():
        st = ref.fresh_state(ids.shape[0], device)
        for f in range(max(at) + 1):
            st = ref.render_frame(rs, sky, cam, st, f, ids, rc)
            if f in at:
                m = frame_mismatch(st, _on(at[f][0], device), at[f][1])
                bad, total = bad + int(m.sum()), total + m.numel()
        for f, pre, post, shown in obs["replay"]:
            st = ref.render_frame(rs, sky, cam, _on(pre, device,
                                                    torch.float32),
                                  f, ids, rc)
            m = frame_mismatch(st, _on(post, device), shown)
            bad, total = bad + int(m.sum()), total + m.numel()
    return {"mismatch_pct": 100.0 * bad / max(total, 1)}


def _on(d: dict, device, float_dtype=None) -> dict:
    return {k: v.to(device=device, dtype=float_dtype)
            if float_dtype is not None and v.is_floating_point()
            else v.to(device) for k, v in d.items()}


def control(cell, seed, device, mode, window_frames=None) -> dict:
    """``mismatch_pct`` with the control in the program's place: the
    sampled pixels rendered in ``mode`` through the set-up frames and
    ``window_frames`` more (by default the traffic's
    ``check_window_from`` and 4), observed as a run observes the
    program."""
    tr = cell.traffic
    window_frames = window_frames or tr["check_window_from"] + 4
    c = harness.Control(mode)
    rs, sky, cam, rc = harness.reference_side(cell, seed, device, c.dtype)
    n = rc["num_pixels"]
    ids = harness.check_pixels(seed, n, tr["check_pixels"])
    ids_d = ids.to(device)
    setup = 1 + tr["warmup_frames"]
    at = set(harness.drawn(seed, 1, tr["check_window_from"],
                           tr["check_window_frames"]))
    cpu = lambda st: {k: v.cpu() for k, v in st.items()}
    shown = lambda st: st["pixels"].float().cpu().numpy()
    obs = {"ids": ids, "chain": [], "replay": []}
    with c, torch.no_grad():
        st = ref.fresh_state(ids.shape[0], device, c.dtype)
        for f in range(setup):
            st = ref.render_frame(rs, sky, cam, st, f, ids_d, rc, c.chains)
        obs["chain"].append((setup - 1, cpu(st), shown(st)))
        for i in range(window_frames):
            new = ref.render_frame(rs, sky, cam, st, setup + i, ids_d, rc,
                                   c.chains)
            if i in at:
                obs["chain"].append((setup + i, cpu(new), shown(new)))
            elif i == window_frames - 1:
                obs["replay"].append((setup + i, cpu(st), cpu(new),
                                      shown(new)))
            st = new
    return compared(cell, seed, obs, device)
