"""Checkpoint and resume of progressive renders (port of
``raytracingpbr_tpu/io/checkpoint.py``).

A checkpoint is one ``.npz`` of the ``FrameState`` tensors and a JSON
metadata blob, written atomically (a temporary file, then a rename).
Resume is bit-exact because every random draw derives from the pixel and
the frame counter, never from hidden state. The layout is the JAX
package's, both ways: the same keys and dtypes (``frame`` int32, the
``respawn`` counter uint32), so a checkpoint of either package resumes in
the other; both counters come back as the port's int64. Older layouts
load with their defaults: no ``respawn`` (zeros), ``hit_t`` (no hit),
``sky_w`` (from the boolean ``nee_flag``, weight ``1 - flag``, or ones) or
split-march carry (nothing in flight).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve
from ..core.types import NO_HIT_T, FrameState, Rays

# checkpoint key -> dtype written
_KEYS = {
    "origin": np.float32, "direction": np.float32, "color": np.float32,
    "depth": np.int32, "accum": np.float32, "frame": np.int32,
    "diff_accum": np.float32, "noise": np.float32, "pixels": np.float32,
    "respawn": np.uint32, "hit_t": np.float32, "sky_w": np.float32,
    "march_state": np.float32, "march_cum": np.int32,
}


def save(path: str, state: FrameState, meta: Optional[dict] = None) -> None:
    """Atomically write ``state`` (copied to the host) and ``meta``."""
    rays = {k: getattr(state.rays, k) for k in ("origin", "direction",
                                                "color", "depth")}
    host = {}
    for k, dt in _KEYS.items():
        v = rays[k] if k in rays else getattr(state, k)
        host[k] = v.detach().cpu().numpy().astype(dt)
    host["_meta"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                  dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **host)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, device=None) -> Tuple[FrameState, dict]:
    """``(state, meta)`` from a checkpoint, the state on ``device`` (the
    card unless given)."""
    device = resolve(device)
    with np.load(path) as z:
        n = z["noise"].shape

        def get(key, default):
            return z[key] if key in z else default
        if "sky_w" in z:
            sky_w = z["sky_w"]
        elif "nee_flag" in z:
            sky_w = 1.0 - z["nee_flag"].astype(np.float32)
        else:
            sky_w = np.ones(n, np.float32)
        arrays = dict(
            accum=z["accum"], diff_accum=z["diff_accum"], noise=z["noise"],
            pixels=z["pixels"],
            frame=np.asarray(z["frame"]).astype(np.int64),
            respawn=get("respawn", np.zeros(n, np.uint32)).astype(np.int64),
            hit_t=get("hit_t", np.full(n, NO_HIT_T, np.float32)),
            sky_w=sky_w,
            march_state=get("march_state", np.zeros(n + (4,), np.float32)),
            march_cum=get("march_cum", np.zeros(n, np.int32)))
        rays = Rays(*(torch.from_numpy(np.array(z[k])).to(device)
                      for k in ("origin", "direction", "color", "depth")))
        meta = json.loads(bytes(z["_meta"]).decode()) if "_meta" in z else {}
    state = FrameState(rays=rays, **{
        k: torch.from_numpy(np.array(v)).to(device)
        for k, v in arrays.items()})
    return state, meta
