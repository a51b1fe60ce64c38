#!/usr/bin/env python3
"""The PyTorch/CUDA port's bench on one NVIDIA card: the port of
``bench.py`` (imports no jax).

    python3 bench_torch.py

Runs ``bench.py``'s protocols, each a function of
``raytracingpbr_tpu_torch/bench.py``, in its order:

- the headline: the Cornell full-PBR wavefront at 480x480 (4 steps a
  frame, a 512-bounce budget), one first frame (the kernels' build), 3
  warm-up frames and 10 timed, in Msamples/s; K1a must launch 4 times a
  frame and no other march kernel;
- the megakernel forward (``render_image`` at spp 1, 6 timed passes);
- fwd+bwd steps at 8 bounces (scan-AD), 128 bounces (path replay) and
  128 bounces with replay + NEE under a 64x32 sun sky (4 timed steps each,
  the albedo's gradient);
- the march utilization: K2's FP32 roof and the Cornell primaries'
  512-trip march through K1a.

Progress goes to stderr, ending in one line ``record {...}``: the launch
counts of each protocol and the port's own utilization shares (the needed
work's rate, the bound's share, the divergence tax). The last line of
stdout is one JSON object with ``bench.py``'s eleven keys, letter for
letter and in its meaning (``march_utilization_pct`` and
``march_achieved_gflops`` count the executed lane-trips), and ``device``:
the card's name and power limit. Without a card it raises and prints no
JSON line; a protocol that raises ends the run with a non-zero exit and no
JSON line. Nothing falls back to the plain march.
"""
import json
import sys

import torch

from raytracingpbr_tpu_torch import bench
from raytracingpbr_tpu_torch.core.device import resolve
from raytracingpbr_tpu_torch.models import cornell

# (key, fwd_bwd's arguments, the march kernels that must launch, label)
FWD_BWD = (
    ("fwd_bwd_msps_8bounce", {}, ("k1a",), "8 bounces"),
    ("fwd_bwd_msps_128bounce_replay",
     dict(max_raytrace=128, differentiable="replay"), ("k1a",),
     "128 bounces, path replay"),
    ("fwd_bwd_msps_128bounce_replay_nee",
     dict(max_raytrace=128, differentiable="replay", env_sampling=True),
     ("k1a", "k1b"), "128 bounces, replay + NEE"),
)


def main():
    dev = resolve(None)
    card = bench.card_line()
    bench.log(f"card: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}")
    record = {"launches": {}}
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))

    cfg = bench.headline_config()
    head = bench.wavefront(scene, env, cam, cfg)
    bench.check_frame_launches("headline", head, cfg, "k1a")
    n = head["launches"]["march"]["k1a"]
    bench.log(f"wavefront first frame (the kernels' build): "
              f"{head['first_s']:.1f}s")
    bench.log(f"wavefront: {head['ms'] / 1e3:.4f}s/frame, "
              f"{head['msps']:.4f} Msamples/s ({head['samples']:.0f} "
              f"samples in the timed frames); K1a launches {n} in "
              f"{head['frames']} frames, {n / head['frames']:g} a frame")
    record["launches"]["headline"] = head["launches"]
    record["headline"] = {k: head[k] for k in ("first_s", "ms", "msps",
                                               "samples", "frames")}

    mega = bench.megakernel(scene, env, cam, cornell.full_config())
    bench.check_kinds("megakernel", mega["launches"], ("k1a",))
    if not bool(torch.isfinite(mega["img"]).all()):
        raise RuntimeError("megakernel: the image is not finite")
    bench.log(f"megakernel fwd: {mega['ms'] / 1e3:.4f}s/pass, "
              f"{mega['msps']:.4f} Msamples/s")
    record["launches"]["megakernel"] = mega["launches"]

    fb = {}
    for key, kw, kinds, label in FWD_BWD:
        r = bench.fwd_bwd(device=dev, **kw)
        bench.check_kinds(label, r["launches"], kinds)
        bench.check_grads(label, r["grads"])
        bench.log(f"fwd+bwd ({label}): {r['s']:.4f}s/step, "
                  f"{r['msps']:.4f} Msamples/s, peak {r['mem_gib']:.3f} GiB")
        fb[key] = r["msps"]
        record["launches"][key] = r["launches"]

    util = bench.utilization(dev)
    bench.check_kinds("utilization", util["launches"], ("k1a",))
    if not util["launches"]["k2"]:
        raise RuntimeError("utilization: K2 did not launch")
    st, ex = util["stats"], util["executed"]
    bench.log(
        f"march utilization: {ex['utilization_pct']:.1f}% of the FP32 roof "
        f"({ex['achieved_gflops']:.0f}/{ex['roof_gflops']:.0f} Gflop/s, "
        f"{st['lane_iters_executed']} lane-iters executed "
        f"({st['divergence_tax_pct']:.0f}% divergence tax) @ "
        f"{st['flops_per_iter']} flops/iter, {st['march_ms']:.2f} ms/march)")
    bench.log(
        f"march, the port's own shares: the needed work "
        f"({st['lane_iters_needed']} lane-iters) at "
        f"{st['achieved_gflops']:.1f} Gflop/s, {st['utilization_pct']:.2f}% "
        f"of the roof; bound {st['bound_ms']:.4f} ms ({st['bound_by']}), "
        f"{st['bound_share_pct']:.2f}% of the time")
    record["launches"]["utilization"] = util["launches"]
    record["utilization"] = {k: st[k] for k in (
        "march_ms", "lane_iters_executed", "lane_iters_needed",
        "flops_per_iter", "achieved_gflops", "utilization_pct",
        "divergence_tax_pct", "bound_ms", "bound_by", "bound_share_pct",
        "roof_gflops")}

    out = bench.bench_json(head["msps"], mega["msps"],
                           [fb[k] for k, *_ in FWD_BWD], ex, card)
    bench.check_positive("bench_torch.py", {
        k: out[k] for k in bench.KEYS if k not in ("metric", "unit")})
    bench.log(bench.RECORD + json.dumps(record))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
