"""The benchmark's driver: one cell of ``BENCHMARK.json`` run once.

A cell names a configuration (``configs/<name>.json``: the scene's objects
and materials, the camera, the sky, the render settings, the bunny's
weights) and a traffic mix (``traffic/<name>.json``: its ``kind`` and
parameters). The kind names the generator of the mix's work,
``kinds/<kind>.py``, found by name (``kinds/__init__.py`` says what it
provides): its set-up builds the program's objects from the data and warms
up the cell's own shapes, and is timed; this module then times whole units
of the kind's work for the given seconds, the window ending in a
synchronise; after it, the compared numbers come from the plain reference
(``reference/``) and the limits in ``limits/<cell>.json``.

With ``trace`` a steady sub-window of the window (the traffic's
``trace_skip_units`` and ``trace_units``) runs under ``torch.profiler``
with the benchmark's spans, the sub-window's march calls are recorded as
its units run again after the window (``trace.py``), and each per-layer
metric's reader (``metrics/<name>.py``) reads them.

A metric named ``<base>.<qualifier>`` that has no reader or reading of its
own reads as ``<base>`` does (:func:`by_name`): the qualifier splits one
quantity between cells that need bounds of their own or move different
end-to-end metrics.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import time
from pathlib import Path
from typing import Optional

import torch

from . import program, trace as tracelib
from .metrics import work
from .reference import part as ref_part
from .reference import stage as ref_stage
from .reference import render as ref
from .reference import scene as ref_scene

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
GIB = 2.0 ** 30
# what a compared float may differ by and still count as the reference's:
# the program and the reference round alike, so only rounding is allowed
RTOL, ATOL = 1e-5, 1e-6


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict     # the configuration file's data
    traffic: dict    # the traffic file's data
    limits: dict     # {number: {"limit": ...}}
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def render(self) -> dict:
        """The render settings: the configuration's, with the traffic's
        overrides."""
        r = dict(self.config["render"])
        r.update(self.traffic.get("render", {}))
        return r

    def mlp_path(self) -> Optional[Path]:
        w = self.config.get("weights")
        return ROOT / "configs" / w if w else None


def resolve(spec: dict, name: str) -> Cell:
    """The cell ``name`` of ``spec`` (BENCHMARK.json's data) with every
    file it names loaded. Raises KeyError for a cell that is not there."""
    w = {c["name"]: c for c in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(REPO / conf["file"])
    traffic = load_json(ROOT / "traffic" / f"{w['traffic']}.json")
    lim = ROOT / "limits" / f"{name}.json"
    limits = load_json(lim) if lim.exists() else {}
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if name in m.get("workloads", [name] if m["moves"] in names
                            else [])]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per)


def load_kind(kind: str):
    """The module ``kinds/<kind>.py`` of a traffic's ``kind``."""
    path = ROOT / "kinds" / f"{kind}.py"
    if not kind.isidentifier() or not path.is_file():
        raise ValueError(f"no traffic kind {kind!r}: benchmark/kinds/"
                         f"{kind}.py is not there")
    return importlib.import_module(f"{__package__}.kinds.{kind}")


def by_name(found: dict, name: str):
    """``found[name]``, or that of the longest ``.``-prefix of ``name``
    that ``found`` has; None where it has none."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        key = ".".join(parts[:k])
        if key in found:
            return found[key]
    return None


def reader_path(name: str) -> str:
    """The reader file of per-layer metric ``name``: ``metrics/<name>.py``,
    or that of its longest ``.``-prefix that has one."""
    files = {p.stem: str(p) for p in (ROOT / "metrics").glob("*.py")}
    path = by_name(files, name)
    if path is None:
        raise KeyError(f"no reader for {name!r} under benchmark/metrics")
    return path


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """The card's cached blocks handed back, before the reference runs."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sample_count(accum: torch.Tensor) -> float:
    return float(accum[:, 3].double().sum())


def check_pixels(seed: int, n: int, k: int) -> torch.Tensor:
    """``k`` distinct pixel ids of ``n``, drawn from the seed, sorted."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=g)[:min(k, n)].sort().values


def drawn(seed: int, salt: int, n: int, k: int) -> list:
    """``k`` distinct indices below ``n`` drawn from the seed."""
    g = torch.Generator().manual_seed(int(seed) * 7919 + salt)
    return sorted(torch.randperm(n, generator=g)[:min(k, n)].tolist())


def reference_side(cell: Cell, seed: int, device, dtype=torch.float32):
    """The reference's scene, sky, camera and settings, built from the
    cell's data (and the sky image made again) in ``dtype``."""
    cfg = cell.config
    path = cell.mlp_path()
    mlp = ref_scene.load_mlp(str(path), device) if path else None
    rs = ref_scene.build_scene(cfg["objects"], cfg["box_round"], device, mlp)
    sky = ref.make_sky(cfg["sky"], ref.sky_image(cfg["sky"]), device)
    cam = ref.make_camera(cfg["camera"], device)
    if dtype != torch.float32:
        rs = rs.to(dtype)
        cam = {k: v.to(dtype) for k, v in cam.items()}
        if "image" in sky:
            sky = dict(sky, image=sky["image"].to(dtype),
                       scale=sky["scale"].to(dtype))
    return rs, sky, cam, ref.settings(cell.render(), seed,
                                      cfg.get("reference_features", ()))


def close(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per lane (first axis): every entry of ``a`` equal to ``b``'s (ints),
    or within RTOL / ATOL of it (floats; NaN where both are)."""
    a, b = a.to(b.device), b
    if not a.is_floating_point() and not b.is_floating_point():
        ok = a == b
    else:
        a, b = a.double(), b.double()
        ok = ((a - b).abs() <= ATOL + RTOL * b.abs()) | (a.isnan()
                                                         & b.isnan())
    return ok.reshape(ok.shape[0], -1).all(dim=1)


class Control:
    """The lower-precision control's settings while it computes (``mode``
    ``bfloat16``: that dtype; ``tf32``: float32 with TF32 matrix products
    on and the bunny's MLP in its matrix form)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
        self.chains = mode != "tf32"

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        if self.mode == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


@dataclasses.dataclass
class Run:
    """What one run measured and saw."""
    metrics: dict
    attempted: int
    failed: int
    memory_peak: int
    compared: dict = dataclasses.field(default_factory=dict)
    trace: Optional[tracelib.Trace] = None
    extra: dict = dataclasses.field(default_factory=dict)


def _memory(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def _reset_memory(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_top: float, rt=None) -> Run:
    """One run of ``cell``: its kind's set-up, then its units until
    ``seconds`` have passed, then (with ``trace``) the trace's readings and
    the compared numbers. ``rt``: the program's package (the default) or
    a stand-in with the entries the kind calls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = load_kind(cell.kind)
    tr = cell.traffic
    spans = tracelib.Spans()
    ctx = kind.setup(cell, seed, device, rt or program.port(), spans, trace)
    sync(device)
    setup_peak = _memory(device)
    _reset_memory(device)
    skip, n_traced = tr["trace_skip_units"], tr["trace_units"]
    captured, prof, times, i = {}, None, [], 0
    t_start = time.perf_counter()
    setup_s = t_start - t_top
    try:
        while True:
            if trace and i == skip:
                prof = tracelib.profiled(captured)
                prof.__enter__()
                spans.on = True
            u0 = time.perf_counter()
            kind.unit(ctx, i, trace and skip <= i < skip + n_traced)
            u1 = time.perf_counter()
            times.append(u1 - u0)
            i += 1
            if prof is not None and i == skip + n_traced:
                spans.on = False
                prof.__exit__(None, None, None)
                prof = None
            if u1 - t_start >= seconds and (not trace
                                            or i >= skip + n_traced):
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    sync(device)
    window_s = time.perf_counter() - t_start
    window_peak = _memory(device)
    metrics = kind.metrics(ctx, i, window_s, times)
    metrics.update(peak_mem_gib=window_peak / GIB, setup_s=setup_s)
    run = Run(metrics=metrics, attempted=i, failed=0,
              memory_peak=max(setup_peak, window_peak),
              extra={"units": i, "window_s": window_s})
    t_after = time.perf_counter()
    if trace:
        recorder = tracelib.MarchRecorder()
        with recorder.installed():
            kind.replay(ctx, skip, n_traced, recorder)
        calls = recorder.calls
        bounds = march_bounds(cell, seed, calls, device)
        run.trace = tracelib.build(cell.kind, n_traced, captured, spans,
                                   bounds)
        del recorder, calls
    run.extra["trace_read_s"] = time.perf_counter() - t_after
    t_check = time.perf_counter()
    run.compared = kind.compare(ctx, device)
    run.extra["check_s"] = time.perf_counter() - t_check
    run.extra.update(ctx.extra)
    return run


# --- the march calls' work, for the roofline ---------------------------------


def march_bounds(cell: Cell, seed: int, calls: list, device) -> list:
    """``metrics/work.march_bound`` of each recorded march call: the trips
    each lane needed, and those inside the support of a shape that has one
    (the bunny's unit sphere), counted by the reference's march on the
    call's own inputs, its MLP in the matrix form (it counts trips, not the
    program's rounding, and takes a third of the chains' time)."""
    if not calls:
        return []
    rs, _, _, ref_rc = reference_side(cell, seed, device)
    shapes = list(rs.types)
    mats = rs.matrix.cpu().tolist()
    perms = [work.is_signed_permutation(m) for m in mats]
    support = []
    for b, name in enumerate(rs.bucket_shapes):
        radius = getattr(ref_part("shapes", name), "SUPPORT_RADIUS", None)
        if radius is not None:
            support += [(i, radius) for i in range(rs.splits[b],
                                                   rs.splits[b + 1])]
    march = ref_stage(ref_rc, "march")
    out = []
    for c in calls:
        cfg = c["cfg"]
        rc = dict(ref_rc, omega=cfg.omega,
                  omega_policy=cfg.omega_policy.value,
                  hit_criterion=cfg.hit_criterion.value,
                  hit_precision=cfg.hit_precision, march_t0=cfg.march_t0,
                  max_dis=cfg.max_dis, pixel_radius=cfg.pixel_radius)
        inside = torch.zeros((), dtype=torch.int64, device=device)

        def on_trip(pos, live):
            nonlocal inside
            for b, radius in support:
                p = ref_scene.to_object_space(
                    pos, rs.position[b], rs.matrix[b], rs.local_offset[b])
                r = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
                               + p[:, 2] * p[:, 2])
                inside = inside + (live & ~(r > radius)).sum()

        r = march(rs, c["origin"], c["direction"], rc, cfg.max_raymarch,
                  c["active"], c["init"], chains=False,
                  on_trip=on_trip if support else None)
        out.append(work.march_bound(
            shapes, perms, lanes=c["origin"].shape[0],
            needed=int(r.fin.to(torch.int64).sum()), support=int(inside),
            gated=c["active"] is not None, resumed=c["init"] is not None,
            bunny_mxu=cfg.bunny_mxu, escape_bound=cfg.escape_bound))
    return out


# --- one run, as the command line gives it -----------------------------------


def result_line(cell: Cell, run: Run, trace: bool, device_name: str,
                chips: int) -> dict:
    """The result's JSON object: with ``trace`` the cell's per-layer
    metrics (those its readers found), else its end-to-end metrics; the
    compared numbers beside their limits last."""
    compared = {}
    correct = True
    for k, v in run.compared.items():
        lim = cell.limits.get(k, {}).get("limit")
        ok = lim is not None and math.isfinite(v) and v <= lim
        correct = correct and ok
        compared[k] = {"value": v, "limit": lim}
    if not run.compared:
        correct = False
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = tracelib.read_metric(reader_path(m["name"]), run.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = by_name(run.metrics, m["name"])
            if v is None:
                raise KeyError(f"{cell.name}'s traffic kind {cell.kind!r} "
                               f"reports no {m['name']!r}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": device_name, "count": chips,
           "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_us() * 1e-6
        dev["window_s"] = run.trace.window_us * 1e-6
        out["breakdown"] = tracelib.breakdown(run.trace)
    out["compared"] = compared
    return out
