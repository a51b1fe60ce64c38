"""Structured metrics logging (port of the part of
``raytracingpbr_tpu/utils/profiling.py`` that the offline renderer uses):
one JSON object per frame, appended to a JSONL file."""
from __future__ import annotations

import json
import time
from typing import Optional


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

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
