#!/usr/bin/env python3
"""Times the phased (compacted) march against the single-shot march
kernel on the frames' own calls, in turns on one card, and beside them a
variant of the phased march that launches each phase over the lanes still
going alone.

    PYTHONPATH=. python3 tools/ab_phased_march.py [--reps N]

The calls, at full width, made as ``chip_smoke.py`` makes them:
- the Cornell full megakernel's bounces 0 and 1 at 480x480, 512 trips in
  5 phases (K1a), recorded in one pass of ``render_image``;
- the engine 768x432 and tokyo 2880x1620 primaries over 512 trips (K1b);
- the glass megakernel's bounces 0 and 1 at 1920x1080 (the scene animated
  to frame 12), 2048 trips in 7 phases, with K1c and with K1d.

Three ways to march a call:
- ``single``: one launch of the whole budget;
- ``phased``: ``ops/march.march_phased``, each phase launched over the
  whole batch (the lanes done gated off at the back), no host sync;
- ``prefix``: the same partitions, each phase after the first launched
  over the prefix of lanes still going, whose count is read on the host
  (one sync a phase).

On each call the three give the same eight outputs bit for bit (K1d: the
phased ways against the single one, held to ``march.assert_march_close``
and said whether bit-equal). Then each is timed in the order single,
phased, prefix, prefix, phased, single: the median of ``--reps`` calls
(CUDA events around a call), and back to back behind a sleep
(``chip_smoke.device_ms``). Prints a line a call and, last, a JSON summary
with the card's name and power limit.
"""
import argparse
import json
import statistics

import torch

from chip_smoke import (FIELDS, card_line, device_ms, k1b_paths, log,
                        median_ms, primaries, record_pass)
from raytracingpbr_tpu_torch.kernels import build, march_kernel
from raytracingpbr_tpu_torch.models import bunny, cornell
from raytracingpbr_tpu_torch.ops import compact as compactlib
from raytracingpbr_tpu_torch.ops import march
from raytracingpbr_tpu_torch.ops import scene as scenelib


def march_phased_prefix(scene, origin, direction, cfg, active=None):
    """``march.march_phased`` with each phase after the first launched over
    the lanes still going alone (their count read on the host)."""
    phases = march.resolve_phases(cfg)
    n = origin.shape[0]
    dev = origin.device
    init = tuple(torch.full((n,), v, dtype=origin.dtype, device=dev)
                 for v in (cfg.march_t0, cfg.omega, 0.0, scenelib.MAX_DIS))
    order = torch.arange(n, device=dev)
    rr = march.march_resumable(scene, origin, direction,
                               cfg.replace(max_raymarch=phases[0]),
                               active=active, init=init)
    t, w, s, d, index, hit, fin, done = (rr.t, rr.w, rr.s, rr.d, rr.index,
                                         rr.hit, rr.fin, rr.done)
    for budget in phases[1:]:
        perm = compactlib.actives_first_perm(done == 0)
        order, t, w, s, d, index, hit, fin, done = (
            v.index_select(0, perm)
            for v in (order, t, w, s, d, index, hit, fin, done))
        live = int((done == 0).sum())
        if live == 0:
            break
        ids = order[:live]
        rr = march.march_resumable(
            scene, origin.index_select(0, ids), direction.index_select(0, ids),
            cfg.replace(max_raymarch=budget),
            init=(t[:live], w[:live], s[:live], d[:live]))
        for v, u in ((t, rr.t), (w, rr.w), (s, rr.s), (d, rr.d),
                     (index, rr.index), (hit, rr.hit), (done, rr.done)):
            v[:live] = u
        fin[:live] += rr.fin
    return march.ResumableResult(*(
        torch.empty_like(v).index_copy_(0, order, v)
        for v in (t, index, hit, fin, w, s, d, done)))


def calls(dev):
    """{label: (scene, origin, direction, active, cfg)} of the frames'
    calls."""
    out = {}
    cfg = cornell.full_config()
    scene = cornell.full_scene(dev)
    rec, names, _ = record_pass(scene, cornell.sky(dev),
                                cornell.full_camera(dev), cfg)
    for (o, d, a, _, c), name in list(zip(rec, names))[:2]:
        out[f"cornell megakernel 480x480 {name}"] = (scene, o, d, a, c)
    for label, (sc, _, cam, c) in k1b_paths(dev).items():
        o, d = primaries(c, cam)
        out[f"{label} primaries"] = (sc, o, d, None, c)
    gcfg = bunny.glass_config()
    glass = bunny.animated_scene(bunny.glass_scene(dev),
                                 torch.tensor(12.0, device=dev))
    rec, names, _ = record_pass(glass, bunny.glass_environment(device=dev),
                                bunny.camera(gcfg.width / gcfg.height, dev),
                                gcfg)
    for (o, d, a, _, c), name in list(zip(rec, names))[:2]:
        for mxu in (False, True):
            out[f"glass megakernel 1920x1080 {name}, "
                f"{'K1d' if mxu else 'K1c'}"] = (
                    glass, o, d, a, c.replace(bunny_mxu=mxu))
    return out


def ab(label, scene, o, d, a, cfg, reps):
    ways = {
        "single": lambda: march.ResumableResult(
            *march_kernel.march_resumable_cuda(scene, o, d, cfg, active=a)),
        "phased": lambda: march.march_phased(scene, o, d, cfg, active=a),
        "prefix": lambda: march_phased_prefix(scene, o, d, cfg, active=a)}
    ref = ways["single"]()
    kind = march_kernel.variant(scene, cfg)
    equal = {}
    for way in ("phased", "prefix"):
        got = ways[way]()
        differ = [n for n, x, y in zip(FIELDS, got, ref)
                  if not torch.equal(x, y)]
        if differ and kind != "k1d":
            raise AssertionError(f"{label}: {way} differs in {differ}")
        if differ:
            march.assert_march_close(scene, o, d, got, ref, cfg)
        equal[way] = not differ
    ms = {w: [] for w in ways}
    dev_ms = {w: [] for w in ways}
    for way in ("single", "phased", "prefix", "prefix", "phased", "single"):
        ms[way].append(median_ms(ways[way], reps))
        dev_ms[way].append(device_ms(ways[way], reps))
    out = {w: dict(ms=statistics.mean(ms[w]),
                   device_ms=statistics.mean(dev_ms[w]), readings=ms[w])
           for w in ways}
    out["bit_equal"] = equal
    out["phases"] = len(march.resolve_phases(cfg))
    log(f"{label}: {kind.upper()}, {o.shape[0]} lanes "
        f"({o.shape[0] if a is None else int(a.sum())} active), "
        f"{cfg.max_raymarch} trips in {out['phases']} phases; "
        + "; ".join(f"{w} {out[w]['ms']:.4f} ms a call "
                    f"({', '.join(f'{v:.4f}' for v in ms[w])}), "
                    f"{out[w]['device_ms']:.4f} back to back" for w in ways)
        + f"; bit-equal to single: {equal}")
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    dev = torch.device("cuda", 0)
    build.build_all()
    log(f"card: {card_line()}")
    summary = {}
    for label, (scene, o, d, a, cfg) in calls(dev).items():
        summary[label] = ab(label, scene, o, d, a, cfg, args.reps)
    print(json.dumps({"card": card_line(), "calls": summary}), flush=True)


if __name__ == "__main__":
    main()
