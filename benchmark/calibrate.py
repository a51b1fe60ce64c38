"""The readings that a cell's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3 [--out FILE]

For each of ``--seeds`` one run of the cell as ``run.py`` makes it (the
timed path, a window of ``--seconds``), and its compared numbers: the lower
readings. For each of ``--control-seeds`` the control: the plain reference
put in the program's place, computed in the nearest precision below the
one the configuration states (bfloat16 for float32; TF32 matrix products,
with the bunny's MLP in its matrix form everywhere, for float32 with TF32
off), and compared as the program is (``kinds/<kind>.py``'s
``control``): the upper readings. Prints one JSON
object (and writes it to ``--out``): every reading, the largest lower
and the smallest upper reading of each number.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def control_mode(cell: harness.Cell) -> str:
    """``"bfloat16"`` or ``"tf32"``: the precision below the
    configuration's."""
    return "tf32" if "tf32 off" in cell.config["precision"] else "bfloat16"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    seeds = [int(x) for x in a.seeds.split(",") if x]
    controls = [int(x) for x in a.control_seeds.split(",") if x]
    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.resolve(spec, a.workload)
    device = torch.device(a.device)
    mode = control_mode(cell)
    out = {"workload": a.workload, "control": mode, "program": {},
           "control_readings": {}}
    for s in seeds:
        t0 = time.perf_counter()
        run = harness.run_cell(cell, s, a.seconds, False, device, t0)
        out["program"][s] = dict(run.compared, seconds=time.perf_counter()
                                 - t0, **{k: run.extra[k] for k in
                                          ("check_s",)})
        print(f"program seed {s}: {out['program'][s]}", file=sys.stderr,
              flush=True)
    for s in controls:
        t0 = time.perf_counter()
        got = harness.load_kind(cell.kind).control(cell, s, device, mode)
        out["control_readings"][s] = dict(got, seconds=time.perf_counter()
                                          - t0)
        print(f"control seed {s}: {out['control_readings'][s]}",
              file=sys.stderr, flush=True)
    names = sorted({k for v in list(out["program"].values())
                    + list(out["control_readings"].values()) for k in v}
                   - {"seconds", "check_s"})
    out["lower"] = {k: max(v[k] for v in out["program"].values())
                    for k in names if out["program"]}
    out["upper"] = {k: min(v[k] for v in out["control_readings"].values())
                    for k in names if out["control_readings"]}
    text = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
