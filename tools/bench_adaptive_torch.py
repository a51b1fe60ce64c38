#!/usr/bin/env python3
"""What adaptive sampling and frame compaction pay on one NVIDIA card: the
port of ``tools/bench_adaptive.py`` (imports no jax).

    python3 tools/bench_adaptive_torch.py [--device cuda] [--early 10]
        [--converge 120] [--late 10] [--threshold 1e-2]

The Cornell full box at 480x480, 4 steps a frame, with adaptive sampling
off and then on (``raytracingpbr_tpu_torch/bench.adaptive_payoff``): ms a
frame over the early frames, and after the converging frames over the
late ones, with the share of pixels still above the noise threshold; with
adaptive sampling also the late frames over the state compacted
actives-first and one recompaction's ms. The counts default to the JAX
script's. Progress goes to stderr; the last line of stdout is one JSON
object of the results, the launches and the card. Without a card it
raises unless given ``--device cpu``.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from raytracingpbr_tpu_torch import bench  # noqa: E402
from raytracingpbr_tpu_torch.core.device import resolve  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    for k, v in bench.ADAPTIVE_FRAMES.items():
        p.add_argument(f"--{k}", type=int, default=v)
    p.add_argument("--threshold", type=float, default=1e-2)
    args = p.parse_args(argv)
    dev = resolve(args.device)
    card = bench.card_line() if dev.type == "cuda" else "cpu"
    bench.log(f"card: {card}")
    out = bench.adaptive_payoff(dev, args.early, args.converge, args.late,
                                args.threshold)
    print(json.dumps({"adaptive_off": out[False], "adaptive_on": out[True],
                      "launches": out["launches"], "card": card}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
