"""Observability (port of ``raytracingpbr_tpu/utils/profiling.py``): a
steady-state timing harness, an optional profiler trace around a section,
and structured metrics, one JSON object per frame appended to a JSONL
file."""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

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


@contextlib.contextmanager
def xprof_trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the section (the CPU, and the card
    where there is one), written as a Chrome trace to
    ``logdir/trace.json``; nothing when ``logdir`` is None."""
    if not logdir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLogger:
    """Append-only JSONL metrics stream (one object per frame/step). With
    no path, :meth:`log` does nothing."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, **fields) -> None:
        if self._f is None:
            return
        fields.setdefault("t", round(time.time() - self._t0, 3))
        self._f.write(json.dumps(fields) + "\n")
        self._f.flush()

    def frame_stats(self, pixels: np.ndarray, accum: np.ndarray,
                    dt: float, **extra) -> dict:
        """The per-frame stats bundle, logged and returned: the frame's
        seconds, the accumulated sample count over them, mean luma and mean
        samples per pixel (host arrays: ``pixels`` (N, 3), ``accum``
        (N, 4))."""
        count = accum[:, 3]
        stats = dict(
            dt=round(dt, 5),
            samples_per_s=float(count.sum()) / max(dt, 1e-9),
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
