"""Observability (port of ``raytracingpbr_tpu/utils/profiling.py``): a
steady-state timing harness, the program's spans at its layer boundaries,
and structured metrics, one JSON object per frame appended to a JSONL
file.

Spans: ``span(name)`` around a section, or ``@traced(name)`` on a function
whose body is the whole layer, record nothing unless a :func:`recording`
section is open. Off, ``span`` hands back one shared object that does
nothing (a global check and a call; no clock, no allocation, nothing on
the card). On, each span leaves a :class:`SpanRow` on the host clock
``time.perf_counter()``; a span never synchronises the card, so its end is
when the host finished launching the layer's work, not when the card ran
it.
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


def _sync() -> None:
    """Wait for the card's queued work (nothing without a card, where a
    call returns when its work is done)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kw) -> float:
    """Steady-state seconds a call of ``fn(*args, **kw)``: ``warmup``
    calls (kernel builds, caches), then ``iters`` calls timed on the host
    clock between two waits for the card, so its queued work is inside the
    window. On the CPU, wall time."""
    for _ in range(warmup):
        fn(*args, **kw)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _sync()
    return (time.perf_counter() - t0) / iters


class SpanRow(NamedTuple):
    """One recorded span: ``parent`` is the row index of the span that
    enclosed it on the same thread (-1 for none), ``tid`` the thread's
    ``threading.get_ident()`` (``pthread_self``, the thread id that CUPTI
    gives the CUDA runtime calls in a ``torch.profiler`` trace), ``start``
    / ``end`` seconds on ``time.perf_counter()``."""
    name: str
    parent: int
    tid: int
    start: float
    end: float


# the open recording's rows, None while recording is off
_rows: Optional[list] = None
_lock = threading.Lock()
# the span that records nothing, shared by every call while off
_OFF = contextlib.nullcontext()


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open spans' rows, innermost last


_local = _Local()


class _Span:
    __slots__ = ("name", "rows", "index", "parent", "start")

    def __init__(self, name: str, rows: list):
        self.name, self.rows = name, rows

    def __enter__(self):
        stack = _local.stack
        self.parent = stack[-1] if stack else -1
        with _lock:
            self.index = len(self.rows)
            self.rows.append(None)  # the row's place, in order of start
        stack.append(self.index)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.stack.pop()
        self.rows[self.index] = SpanRow(self.name, self.parent,
                                        threading.get_ident(),
                                        self.start, end)
        return False


def is_recording() -> bool:
    """Whether a :func:`recording` section is open."""
    return _rows is not None


def span(name: str):
    """A context manager around the section ``name``: a row of the open
    recording when it exits, nothing while recording is off."""
    rows = _rows
    return _OFF if rows is None else _Span(name, rows)


def traced(name: str):
    """Decorator: the function's every call inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            rows = _rows
            if rows is None:
                return fn(*args, **kw)
            with _Span(name, rows):
                return fn(*args, **kw)
        return inner
    return wrap


@contextlib.contextmanager
def recording():
    """Spans recorded for the section: yields the list of its
    :class:`SpanRow`, in order of start, complete when the section ends (a
    span still open then, on another thread, fills its row as it closes).
    Kept in memory; nothing is written or synchronised."""
    global _rows
    if _rows is not None:
        raise RuntimeError("spans are already being recorded")
    rows: List[Optional[SpanRow]] = []
    _rows = rows
    try:
        yield rows
    finally:
        _rows = None


class MetricsLogger:
    """Append-only JSONL metrics stream (one object per frame/step). With
    no path, :meth:`log` does nothing. ``samples``: the samples the
    accumulator already holds when the stream starts (a resumed state's),
    from which :meth:`frame_stats` counts the first frame's."""

    def __init__(self, path: Optional[str], samples: float = 0.0):
        self.path = path
        self._f = open(path, "a") if path else None
        self._t0 = time.time()
        self._samples = float(samples)

    def log(self, **fields) -> None:
        if self._f is None:
            return
        fields.setdefault("t", round(time.time() - self._t0, 3))
        self._f.write(json.dumps(fields) + "\n")
        self._f.flush()

    def frame_stats(self, pixels: np.ndarray, accum: np.ndarray,
                    dt: float, **extra) -> dict:
        """The per-frame stats bundle, logged and returned: the frame's
        seconds, the samples it completed over them (the growth of the
        accumulated count since the last frame, or the whole count where a
        refresh zeroed it), mean luma and mean samples per pixel (host
        arrays: ``pixels`` (N, 3), ``accum`` (N, 4))."""
        count = accum[:, 3]
        total = float(count.sum(dtype=np.float64))
        done = total - self._samples if total >= self._samples else total
        self._samples = total
        stats = dict(
            dt=round(dt, 5),
            samples_per_s=done / max(dt, 1e-9),
            mean_luma=float(
                (pixels * np.array([0.299, 0.587, 0.114])).sum(-1).mean()),
            mean_spp=float(count.mean()),
            **extra,
        )
        self.log(**stats)
        return stats

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
