"""The traced run's readings: a ``torch.profiler`` trace of the card over a
steady sub-window of the measured window, the benchmark's own host spans
around its calls into the program, and the march calls that the
sub-window's units make, with what each needed.

:class:`Trace` is what a per-layer metric's reader (``metrics/<name>.py``)
is given. Device events are the profiler's kernels, copies and sets;
a kernel is a march kernel when its name holds one of :data:`MARCH_KERNELS`
(the program's K1a-K1d entry points).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional

import torch

# the names of the program's march kernels (csrc/march.cu: K1a and K1b;
# csrc/march_pool.cuh: K1c and K1d)
MARCH_KERNELS = ("march_kernel", "pool_kernel")


@dataclasses.dataclass
class Trace:
    kind: str                 # the traffic's kind (``kinds/<kind>.py``)
    units: int                # frames or steps in the sub-window
    window: tuple             # (start, end) of the sub-window, us
    kernels: List[tuple]      # (name, start, duration), us
    device: List[tuple]       # kernels, copies and sets
    spans: List[tuple]        # the benchmark's spans (name, start, duration)
    host: List[tuple]         # the CUDA runtime calls (name, start, duration)
    bounds: List[dict]        # metrics/work.march_bound of each march call

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def march_kernels(self):
        return [k for k in self.kernels if is_march(k[0])]

    def _intervals(self):
        lo, hi = self.window
        return sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.device
                      if s + d > lo and s < hi)

    def busy_us(self) -> float:
        """The time in the sub-window in which some device event ran."""
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in self._intervals():
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def idle_gaps(self):
        """The sub-window's idle intervals on the device, (start, end)."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self._intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps


def is_march(name: str) -> bool:
    return any(k in name for k in MARCH_KERNELS)


class MarchRecorder:
    """Records the program's march calls while on: each call's inputs,
    through the program's module attribute ``ops.march.march_resumable``
    (the frames' split march and the megakernel's full march both reach
    it). The harness turns it on while it runs the traced sub-window's
    units again after the window, so that the profiled units allocate
    nothing to hold them."""

    def __init__(self):
        self.calls = []
        self.on = False

    @contextlib.contextmanager
    def installed(self):
        from raytracingpbr_tpu_torch.ops import march as pmarch
        real = pmarch.march_resumable

        def recording(scene, origin, direction, cfg, active=None, init=None):
            out = real(scene, origin, direction, cfg, active=active,
                       init=init)
            if self.on:
                self.calls.append(dict(origin=origin, direction=direction,
                                       cfg=cfg, active=active, init=init))
            return out

        pmarch.march_resumable = recording
        try:
            yield self
        finally:
            pmarch.march_resumable = real


class Spans:
    """The benchmark's host spans, on the host clock, while on."""

    def __init__(self):
        self.rows = []
        self.on = False

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.perf_counter()))


def read_chrome_trace(path: str):
    """(device events (name, start us, duration us, category), CUDA
    runtime calls (name, start us, duration us)) of an exported trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        row = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(row + (cat,))
        elif cat in ("cuda_runtime", "cuda_driver"):
            host.append(row)
    return device, host


@contextlib.contextmanager
def profiled(out: dict):
    """The section under ``torch.profiler`` with the card's activity alone
    (the host's op recording would cost each launch tens of microseconds
    and so make a host-bound frame look idle). The section starts and ends
    with a synchronise; the first one's runtime call ties the host clock
    to the trace's. On exit ``out`` has ``device``, ``host`` (the runtime
    calls), ``t0`` / ``t1`` (host clock) and ``offset_us`` (trace time of
    host time 0). Without a card (the tests) the host's activity stands
    in."""
    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [torch.profiler.ProfilerActivity.CUDA if card
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        out["t0"] = time.perf_counter()
        yield
        sync()
        out["t1"] = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["device"], out["host"] = read_chrome_trace(path)
    finally:
        os.unlink(path)
    syncs = sorted((s + d) for n, s, d in out["host"]
                   if n == "cudaDeviceSynchronize")
    out["offset_us"] = (syncs[0] - out["t0"] * 1e6) if syncs else 0.0


def build(kind: str, units: int, captured: dict, spans: Spans,
          bounds: List[dict]) -> Trace:
    """The :class:`Trace` of a captured sub-window (:func:`profiled`)."""
    off = captured["offset_us"]
    us = lambda t: t * 1e6 + off
    rows = [(n, us(a), (b - a) * 1e6) for n, a, b in spans.rows]
    device = [(n, st, du) for n, st, du, _ in captured["device"]]
    kernels = [(n, st, du) for n, st, du, cat in captured["device"]
               if cat == "kernel"]
    return Trace(kind, units, (us(captured["t0"]), us(captured["t1"])),
                 kernels, device, rows, captured["host"], bounds)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the benchmark's span and the CUDA runtime call the
    host was in at the gap's middle (``host`` where it was in none)."""
    ops = {}
    lo, hi = tr.window
    for name, s, d in tr.device:
        if lo <= s < hi:
            ops[name[:120]] = ops.get(name[:120], 0.0) + d * 1e-6
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    idle = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        span = [n for n, s, d in tr.spans if s <= mid <= s + d]
        call = [h for h in tr.host if h[1] <= mid <= h[1] + h[2]]
        name = ((span[-1] if span else "outside the spans") + "/"
                + (min(call, key=lambda h: h[2])[0] if call else "host"))
        idle.append([name, (g1 - g0) * 1e-6])
    return {"device_ops": [[n, v] for n, v in device_ops],
            "idle_gaps": idle}


def load_reader(path: str):
    """The ``read(trace)`` function of a metric's reader file."""
    import importlib.util
    name = "bench_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metric(path: str, tr: Trace) -> Optional[float]:
    return load_reader(path)(tr)
