"""The program's own spans laid over a traced sub-window: each kernel
credited to the program's layer that launched it, and each idle gap named
by the program's layer the host was in.

The program records its spans with ``utils/profiling.recording()``: rows
``(name, parent, tid, start, end)`` on ``time.perf_counter()``, the
benchmark's host clock. :func:`on_trace_clock` maps them onto the
profiler's clock with the offset that :func:`clock_offset` finds, and
:func:`read_launches` reads what ``trace.read_chrome_trace`` leaves out of
the exported trace: each kernel's ``correlation`` id, and each CUDA
runtime call's ``correlation`` and thread.

A kernel is credited (:func:`credit`) to the innermost program span that
was open, on the thread of the runtime call that launched it, at that
call's middle. A row's thread is ``threading.get_ident()``, which is
``pthread_self``; the trace gives a runtime call's thread as the absolute
value of that id's low 32 bits read as a signed integer, so threads are
matched on that (:func:`thread`).
A kernel launched from a thread with no span open is credited to the
innermost span open then on another thread: autograd's engine thread
runs the backward of a ``torch.autograd.grad`` called inside a span (the
shading's autograd normal) while the caller waits in it. So the kernels of
the grad cells' backward, which the benchmark calls outside every program
span, credit none. A march kernel whose launch call the trace lacks is
credited to ``march`` by its name; any other such kernel, and one launched
while no span is open, is unattributed (``None``).
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from ..trace import is_march

# the program's spans whose own kernels are the wavefront's bookkeeping
WAVEFRONT = ("frame", "step", "camera", "post")
# kernels credited by name, their launch call missing from the trace
BY_NAME = -2


def thread(tid) -> Optional[int]:
    """A thread id as the trace writes it: the absolute value of its low
    32 bits as a signed integer (a negative id written as such reads the
    same)."""
    if tid is None:
        return None
    v = int(tid) & 0xFFFFFFFF
    return v if v < 1 << 31 else (1 << 32) - v


def _int(v) -> Optional[int]:
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


def read_launches(path: str):
    """``(kernels, calls)`` of an exported Chrome trace: kernels as
    ``(name, start us, duration us, correlation)``, CUDA runtime and driver
    calls as ``(name, start us, duration us, correlation, tid)``."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    kernels, calls = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = _int((e.get("args") or {}).get("correlation"))
        row = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
               corr)
        if cat == "kernel":
            kernels.append(row)
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls.append(row + (_int(e.get("tid")),))
    return kernels, calls


def clock_offset(host: Sequence, t0: float, t1: float) -> Optional[float]:
    """The profiler's clock in microseconds at host time 0: the profiled
    section starts and ends with a synchronise, taken at host times ``t0``
    and ``t1`` (seconds) as they return. Its two ``cudaDeviceSynchronize``
    calls are the pair among the trace's runtime calls ``host`` (name,
    start, duration) whose ends lie ``t1 - t0`` apart, nearest of all
    pairs: the profiler's own synchronise as it starts comes before the
    section's (on the H100 host 2-4 ms before it), and the units may
    synchronise inside it. None without two synchronises."""
    ends = sorted(s + d for n, s, d in host if n == "cudaDeviceSynchronize")
    want = (t1 - t0) * 1e6
    pairs = [(abs(b - a - want), a, b) for i, a in enumerate(ends)
             for b in ends[i + 1:]]
    if not pairs:
        return None
    _, a, b = min(pairs)
    return 0.5 * ((a - t0 * 1e6) + (b - t1 * 1e6))


def on_trace_clock(rows: Sequence, offset_us: float) -> list:
    """The program's rows with their start and end in microseconds on the
    profiler's clock (:func:`clock_offset`): ``(name, parent, tid, start,
    end)``."""
    return [(r[0], r[1], r[2], r[3] * 1e6 + offset_us,
             r[4] * 1e6 + offset_us) for r in rows]


class Spans:
    """The rows of one recording, looked up by thread and time."""

    def __init__(self, rows: Sequence):
        self.rows = list(rows)
        by_tid = defaultdict(list)
        for i, r in enumerate(self.rows):
            by_tid[thread(r[2])].append(i)
        self.by_tid = {t: sorted(ix, key=lambda i: self.rows[i][3])
                       for t, ix in by_tid.items()}
        self.starts = {t: [self.rows[i][3] for i in ix]
                       for t, ix in self.by_tid.items()}

    def innermost(self, tid, t: float) -> Optional[int]:
        """The index of the innermost row of thread ``tid`` open at ``t``.
        A thread's spans nest, so it is the last one to start before
        ``t``, or the nearest of its ancestors still open."""
        tid = thread(tid)
        ix = self.by_tid.get(tid)
        if not ix:
            return None
        k = bisect.bisect_right(self.starts[tid], t) - 1
        i = ix[k] if k >= 0 else -1
        while i >= 0 and self.rows[i][4] < t:
            i = self.rows[i][1]
        return i if i >= 0 else None

    def innermost_elsewhere(self, tid, t: float) -> Optional[int]:
        """The innermost row open at ``t`` on a thread other than
        ``tid``: of those, the one that started last."""
        tid = thread(tid)
        open_ = [self.innermost(u, t) for u in self.by_tid if u != tid]
        open_ = [i for i in open_ if i is not None]
        return max(open_, key=lambda i: self.rows[i][3], default=None)

    def path(self, i: Optional[int]) -> List[str]:
        """The names from the outermost span down to row ``i``."""
        out = []
        while i is not None and i >= 0:
            out.append(self.rows[i][0])
            i = self.rows[i][1]
        return out[::-1]

    def within(self, i: Optional[int], name: str) -> bool:
        """Whether row ``i`` is a ``name`` row or lies inside one."""
        return i is not None and i >= 0 and name in self.path(i)


def credit(kernels: Sequence, calls: Sequence, spans: Spans) -> list:
    """Per kernel of :func:`read_launches`: the index of the row it is
    credited to, :data:`BY_NAME` for a march kernel with no launch call
    in the trace, or None (unattributed)."""
    launch = {c[3]: c for c in calls if c[3] is not None}
    out = []
    for name, _, _, corr in kernels:
        c = launch.get(corr)
        if c is None:
            out.append(BY_NAME if is_march(name) else None)
            continue
        mid = c[1] + 0.5 * c[2]
        i = spans.innermost(c[4], mid)
        out.append(i if i is not None
                   else spans.innermost_elsewhere(c[4], mid))
    return out


def layer(spans: Spans, i) -> Optional[str]:
    """The layer a credit names: its row's span, ``march`` by name."""
    if i == BY_NAME:
        return "march"
    return None if i is None else spans.rows[i][0]


def device_ms(kernels: Sequence, credits: Sequence, spans: Spans
              ) -> Dict[Optional[str], float]:
    """Device milliseconds of the kernels by the layer each is credited to
    (``None``: unattributed)."""
    out = defaultdict(float)
    for k, i in zip(kernels, credits):
        out[layer(spans, i)] += k[2] * 1e-3
    return dict(out)


def frame_readings(kernels: Sequence, calls: Sequence, rows: Sequence,
                   units: int) -> dict:
    """A frames cell's readings a displayed frame: ``rng_ms``,
    ``shade_ms``, ``sky_ms``, ``wavefront_ms`` (the kernels credited to
    ``frame``, ``step``, ``camera`` or ``post``), ``dispatch_us`` (the
    ``frame`` spans' host time over the kernels launched inside them, the
    march kernels credited by name included), and, for the account,
    ``march_ms`` (march kernels), ``march_in_march_ms`` (those credited to
    ``march``), ``other_ms`` (every other kernel, as
    ``other_device_ms.frame`` reads them), ``march_other_ms`` (those
    credited to ``march``) and ``unattributed_ms`` (those credited to
    none). Empty without rows or kernels."""
    if not rows or not kernels or not units:
        return {}
    spans = Spans(rows)
    credits = credit(kernels, calls, spans)
    marches = [is_march(k[0]) for k in kernels]
    by = device_ms([k for k, m in zip(kernels, marches) if not m],
                   [i for i, m in zip(credits, marches) if not m], spans)
    march = device_ms([k for k, m in zip(kernels, marches) if m],
                      [i for i, m in zip(credits, marches) if m], spans)
    frame_us = sum(r[4] - r[3] for r in spans.rows if r[0] == "frame")
    inside = sum(1 for i in credits
                 if i == BY_NAME or spans.within(i, "frame"))
    out = {f"{n}_ms": by.get(n, 0.0) / units for n in ("rng", "shade",
                                                       "sky")}
    out["wavefront_ms"] = sum(by.get(n, 0.0) for n in WAVEFRONT) / units
    out["march_ms"] = sum(march.values()) / units
    out["march_in_march_ms"] = march.get("march", 0.0) / units
    out["other_ms"] = sum(by.values()) / units
    out["march_other_ms"] = by.get("march", 0.0) / units
    out["unattributed_ms"] = by.get(None, 0.0) / units
    if inside and frame_us:
        out["dispatch_us"] = frame_us / inside
    return out


def step_readings(rows: Sequence, units: int) -> dict:
    """A grad cell's readings a step: ``syncs`` (the ``sync`` spans) and
    ``sync_wait_ms`` (their host time). Empty without rows."""
    if not rows or not units:
        return {}
    waits = [r[4] - r[3] for r in rows if r[0] == "sync"]
    return {"syncs": len(waits) / units,
            "sync_wait_ms": sum(waits) * 1e-3 / units}


def idle_gaps(tr, rows: Sequence, tid, top: int = 10) -> list:
    """``trace.breakdown``'s idle gaps, each name with the path of the
    program's innermost span open on thread ``tid`` at the gap's middle
    put between the benchmark's span and the runtime call (for example
    ``bench.frame/frame/step/rng/host``); a gap outside every program span
    keeps ``breakdown``'s name."""
    spans = Spans(rows)
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    out = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        bench = [n for n, s, d in tr.spans if s <= mid <= s + d]
        call = [h for h in tr.host if h[1] <= mid <= h[1] + h[2]]
        parts = [bench[-1] if bench else "outside the spans"]
        parts += spans.path(spans.innermost(tid, mid))
        parts.append(min(call, key=lambda h: h[2])[0] if call else "host")
        out.append(["/".join(parts), (g1 - g0) * 1e-6])
    return out
