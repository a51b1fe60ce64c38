#!/usr/bin/env python3
"""The reference's workload matrix on one NVIDIA card: the port of
``tools/bench_workloads.py`` (imports no jax).

    python3 tools/bench_workloads_torch.py [--device cuda]

Each of the six rows (``raytracingpbr_tpu_torch/bench.workload_rows``: the
Cornell minimal box at 512x512, the Cornell full box, the engine, tokyo,
the metal bunny at 3840x2160, the glass bunny at 1920x1080) renders at its
native resolution and its own march and bounce budgets, 4 wavefront steps
of one sample a frame: one first frame, 2 warm-up and 5 timed, ending in a
sync. On the card each row's march kernel must launch 4 times a frame and
no other. Progress goes to stderr, ending in one line ``record {...}``
(each row's numbers and launches); stdout has the card's name and power
limit and the markdown table. Without a card it raises (``--device cpu``
runs the rows on the CPU, which takes hours at these sizes).
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
    args = p.parse_args(argv)
    dev = resolve(args.device)
    card = bench.card_line() if dev.type == "cuda" else "cpu"
    rows = bench.workloads(dev)
    bench.log(bench.RECORD + json.dumps({"card": card, "rows": rows}))
    print(f"card: {card}")
    print(bench.workloads_table(rows), flush=True)


if __name__ == "__main__":
    sys.exit(main())
