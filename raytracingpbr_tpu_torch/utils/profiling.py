"""Structured metrics logging (port of the part of
``raytracingpbr_tpu/utils/profiling.py`` that the renderer apps use): one
JSON object per frame, appended to a JSONL file."""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np


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
