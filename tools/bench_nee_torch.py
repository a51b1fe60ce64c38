#!/usr/bin/env python3
"""What environment NEE and specular MIS buy at equal time, on one NVIDIA
card: the port of ``tools/bench_nee.py`` (imports no jax).

    python3 tools/bench_nee_torch.py [--device cuda] [--truth-seconds 60]
        [--run-seconds 3 10] [--diet-seconds 30]

A sun-lit scene of three spheres at 160x160 under a 64x32 sky with a small
bright sun (``raytracingpbr_tpu_torch/bench.nee_setup``), wavefront frames
for a wall-time budget each, every frame ending in a sync: a converged NEE
truth, then the plain and the NEE estimator at each run length
(Msamples/s, mean spp, PSNR against the truth), then the shadow diet on
and off (Msamples/s, and how far the converged means move). The budgets
default to the JAX script's. Progress goes to stderr; the last line of
stdout is one JSON object of the results, the launches and the card.
Without a card it raises unless given ``--device cpu``.
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
    budgets = bench.NEE_BUDGETS
    p.add_argument("--truth-seconds", type=float,
                   default=budgets["truth_s"])
    p.add_argument("--run-seconds", type=float, nargs="+",
                   default=list(budgets["run_s"]))
    p.add_argument("--diet-seconds", type=float, default=budgets["diet_s"])
    args = p.parse_args(argv)
    dev = resolve(args.device)
    card = bench.card_line() if dev.type == "cuda" else "cpu"
    bench.log(f"card: {card}")
    out = bench.nee_equal_time(dev, args.truth_seconds,
                               tuple(args.run_seconds), args.diet_seconds)
    print(json.dumps({**out, "card": card}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
