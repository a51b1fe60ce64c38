"""A benchmark cell's traced sub-window read by the program's own spans, on
one NVIDIA card (imports no jax):

    PYTHONPATH=. python3 tools/trace_layers_torch.py \
        --workload cornell_full.frames [--seed N] [--pairs 3] [--out DIR]

The cell is set up by its traffic kind (``benchmark/kinds/<kind>.py``) as
``benchmark/run.py`` sets it up, and its first ``trace_skip_units`` units
run untimed. Then ``--pairs`` pairs of sub-windows of ``trace_units``
units run under ``torch.profiler`` with the card's activity alone, as
``benchmark/trace.profiled`` runs them, with the benchmark's spans on: in
each pair the same units from the same state (a frames cell's state is
put back; a grad cell's steps are the same steps), once with the
program's spans recorded (``utils/profiling.recording``) and once
without, the order alternating. Each sub-window's readings
(``benchmark/metrics/layers.py``): the device milliseconds a unit of the
kernels credited to each program layer, the host microseconds a launch
of the ``frame`` spans, the ``sync`` spans a step and their host time,
the idle gaps named by layer, and the benchmark's own per-layer readings
beside them. Each pair also says whether both halves launched the same
kernels in the same order, and the recorder's cost: the host time a unit
with the spans on over that with them off. Each sub-window also counts
``ops/scene.calc_normal``'s calls a unit by route (``NORMAL_ROUTES``) and
the normal kernel's launches a unit (``kernels/normal_kernel.LAUNCHES``),
which show where the analytic normal kernel engages, and
``ops/scene.materials_at``'s calls a unit by route (``MATERIAL_ROUTES``)
with the material gradient kernel's calls a unit
(``kernels/material_grad_kernel.LAUNCHES``).

One JSON line a sub-window and a last summary line on stdout; the whole
record in ``--out``/``<workload>.json``. Prints the card's name and power
limit.
"""
import argparse
import collections
import contextlib
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

from benchmark import harness, program
from benchmark import trace as tracelib
from benchmark.metrics import layers
from raytracingpbr_tpu_torch.kernels import material_grad_kernel, normal_kernel
from raytracingpbr_tpu_torch.ops import scene as scenelib
from raytracingpbr_tpu_torch.utils import profiling

READERS = {"frames": ("launches.frame", "other_device_ms.frame",
                      "march_ms.frame", "device_idle_pct.frame"),
           "grad": ("launches.step", "march_ms.step", "device_idle_pct.step",
                    "backward_ms.step")}


@contextlib.contextmanager
def profiled(out: dict):
    """``trace.profiled``, keeping the exported trace's launches with
    their correlation ids and threads (``layers.read_launches``), and
    settled before the section starts: the profiler's first runtime call
    returns milliseconds after the end the trace gives it, and the first
    kernels after it can be missing from the trace. The host clock is
    tied to the trace's by the section's bracketing synchronises
    (``layers.clock_offset``)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        time.sleep(0.02)
        torch.cuda.synchronize()
        out["t0"] = time.perf_counter()
        yield
        torch.cuda.synchronize()
        out["t1"] = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["device"], out["host"] = tracelib.read_chrome_trace(path)
        out["kernels"], out["calls"] = layers.read_launches(path)
    finally:
        os.unlink(path)
    syncs = sorted((s + d) for n, s, d in out["host"]
                   if n == "cudaDeviceSynchronize")
    # trace.profiled's offset, from the first synchronise, for the record
    out["first_sync_offset_us"] = syncs[0] - out["t0"] * 1e6
    out["offset_us"] = layers.clock_offset(out["host"], out["t0"],
                                           out["t1"])


def sub_window(kind, ctx, spans, units, n, record: bool,
               dump: str = "") -> dict:
    """Units ``units`` to ``units + n`` under the profiler, with the
    program's spans recorded or not; its readings. ``dump``: a path to
    write the sub-window's rows, kernels and runtime calls to (gzip'd
    JSON), for reading again without a card."""
    captured = {}
    spans.rows = []
    routes = dict(scenelib.NORMAL_ROUTES)
    launched = normal_kernel.LAUNCHES["normal"]
    materials = dict(scenelib.MATERIAL_ROUTES)
    grads = material_grad_kernel.LAUNCHES["material_grad"]
    rec = profiling.recording() if record else contextlib.nullcontext([])
    with rec as rows, profiled(captured):
        spans.on = True
        for i in range(units, units + n):
            kind.unit(ctx, i, True)
        spans.on = False
    tr = tracelib.build(ctx.cell.kind, n, captured, spans, [])
    got = {"record": record,
           "normal_routes_a_unit": {
               k: (v - routes[k]) / n
               for k, v in scenelib.NORMAL_ROUTES.items()},
           "normal_launches_a_unit":
               (normal_kernel.LAUNCHES["normal"] - launched) / n,
           "material_routes_a_unit": {
               k: (v - materials[k]) / n
               for k, v in scenelib.MATERIAL_ROUTES.items()},
           "material_grad_calls_a_unit":
               (material_grad_kernel.LAUNCHES["material_grad"] - grads) / n,
           "host_ms_a_unit":
           (captured["t1"] - captured["t0"]) * 1e3 / n,
           "offset_vs_first_sync_us": captured["offset_us"]
           - captured["first_sync_offset_us"],
           "kernels_a_unit": len(tr.kernels) / n,
           "kernel_names": [k[0] for k in sorted(tr.kernels,
                                                  key=lambda k: k[1])]}
    for name in READERS[ctx.cell.kind]:
        got[name] = tracelib.read_metric(harness.reader_path(name), tr)
    got["device_ops"] = tracelib.breakdown(tr)["device_ops"]
    kernels, calls = captured["kernels"], captured["calls"]
    tid = threading.get_ident()
    called = {c[3] for c in calls}
    got["kernels_without_call"] = sum(1 for k in kernels
                                      if k[3] not in called)
    if not record:
        got["idle_gaps"] = tracelib.breakdown(tr)["idle_gaps"]
        return got
    if dump:
        names = sorted({k[0] for k in kernels} | {c[0] for c in calls})
        ix = {nm: j for j, nm in enumerate(names)}
        with gzip.open(dump, "wt") as f:
            json.dump({"t0": captured["t0"], "t1": captured["t1"],
                       "offset_us": captured["offset_us"], "this_tid": tid,
                       "names": names, "rows": [list(r) for r in rows],
                       "kernels": [[ix[k[0]]] + list(k[1:]) for k in kernels],
                       "calls": [[ix[c[0]]] + list(c[1:]) for c in calls],
                       "device": captured["device"],
                       "host": captured["host"], "spans": spans.rows}, f)
    prog = layers.on_trace_clock(rows, captured["offset_us"])
    got["program_rows"] = len(prog)
    got["idle_gaps"] = layers.idle_gaps(tr, prog, tid)
    if ctx.cell.kind == "frames":
        got["layers"] = layers.frame_readings(kernels, calls, prog, n)
    else:
        got["layers"] = layers.step_readings(prog, n)
        got["layers"]["bounces"] = sum(r[0] == "bounce" for r in prog) / n
        sp = layers.Spans(prog)
        by = layers.device_ms(kernels, layers.credit(kernels, calls, sp), sp)
        got["layers"]["device_ms_by_layer"] = {
            str(k): v / n for k, v in sorted(by.items(), key=str)}
    return got


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2147483901)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", default="build/layers")
    p.add_argument("--dump", action="store_true",
                   help="write the first recorded sub-window's rows, "
                   "kernels and calls to --out/<workload>.raw.json.gz")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(power_limit(), file=sys.stderr, flush=True)
    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    cell = harness.resolve(spec, a.workload)
    kind = harness.load_kind(cell.kind)
    device = torch.device("cuda", 0)
    spans = tracelib.Spans()
    ctx = kind.setup(cell, a.seed, device, program.port(), spans, False)
    tr = cell.traffic
    n = tr["trace_units"]
    # past the frames kind's checked window frames
    first = max(tr["trace_skip_units"], tr.get("check_window_from", 0))
    for i in range(first):
        kind.unit(ctx, i, False)
    harness.sync(device)
    os.makedirs(a.out, exist_ok=True)
    passes, pairs = [], []
    for k in range(a.pairs):
        units = first + k * n
        held = getattr(ctx, "state", None)
        pair = {}
        for record in ((True, False) if k % 2 == 0 else (False, True)):
            if held is not None:
                ctx.state = held
            dump = (os.path.join(a.out, f"{a.workload}.raw.json.gz")
                    if a.dump and k == 0 and record else "")
            got = sub_window(kind, ctx, spans, units, n, record, dump)
            got["pair"] = k
            pair[record] = got
            passes.append(got)
            line = {x: v for x, v in got.items() if x != "kernel_names"}
            print(json.dumps(line), flush=True)
        on, off = pair[True]["kernel_names"], pair[False]["kernel_names"]
        pairs.append({
            "same_kernels": on == off, "kernels": [len(on), len(off)],
            "on_cost": pair[True]["host_ms_a_unit"]
            / pair[False]["host_ms_a_unit"] - 1.0})
        if on != off:
            j = next((j for j, (x, y) in enumerate(zip(on, off)) if x != y),
                     min(len(on), len(off)))
            pairs[-1]["first_difference"] = [j, on[j - 2:j + 3],
                                             off[j - 2:j + 3]]
            pairs[-1]["only_on"] = list((collections.Counter(on)
                                         - collections.Counter(off))
                                        .items())[:5]
            pairs[-1]["only_off"] = list((collections.Counter(off)
                                          - collections.Counter(on))
                                         .items())[:5]
    for got in passes:
        got.pop("kernel_names")
    summary = {"workload": a.workload, "seed": a.seed, "pairs": pairs,
               "on_cost_median": statistics.median(
                   q["on_cost"] for q in pairs),
               "card": power_limit()}
    with open(os.path.join(a.out, f"{a.workload}.json"), "w") as f:
        json.dump({"summary": summary, "passes": passes}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
