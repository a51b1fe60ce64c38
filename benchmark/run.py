"""Runs one cell of the benchmark of ``raytracingpbr_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number compared beside its limit); the compared numbers
are also the last lines of standard error. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics. Exits non-zero
with no result without a CUDA card (or with fewer than the cell asks for),
and when JAX or the JAX package was loaded in this process.
"""
import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root: the program and the benchmark's package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# a library that would load JAX by itself is kept from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingpbr_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: ``raytracingpbr_tpu_torch`` is not it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    from benchmark import harness
    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.resolve(spec, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{a.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    device = torch.device("cuda", 0)
    run = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), device,
                           T_TOP)
    out = harness.result_line(cell, run, bool(a.trace),
                              torch.cuda.get_device_name(0), cell.chips)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process after the window: {bad}")
        return 3
    log(json.dumps({"extra": run.extra, "power_limit": _power_limit()}))
    for k, v in out["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


if __name__ == "__main__":
    sys.exit(main())
