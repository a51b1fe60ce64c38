"""Numerical-health checks of the wavefront's state (port of
``raytracingpbr_tpu/utils/validate.py``): NaN or Inf creeping through the
ray state (a grazing refraction's square root, say) is the hazard. Cheap
enough to run every frame while debugging; off by default. Each check
copies the tensors it reads to the host, a sync."""
from __future__ import annotations

from typing import Dict

import torch

from ..core.types import FrameState


def state_health(state: FrameState) -> Dict[str, float]:
    """Host-side health summary: the finite fraction and the largest finite
    magnitude of each ray-state tensor, and the share of live lanes whose
    direction is a unit vector."""
    out = {}
    leaves = {
        "origin": state.rays.origin,
        "direction": state.rays.direction,
        "color": state.rays.color,
        "accum": state.accum,
        "pixels": state.pixels,
    }
    for name, arr in leaves.items():
        a = arr.detach().to("cpu", torch.float64)
        fin = torch.isfinite(a)
        out[f"{name}_finite_frac"] = float(fin.to(torch.float64).mean())
        out[f"{name}_absmax"] = (float(a[fin].abs().max()) if bool(fin.any())
                                 else float("inf"))
    norms = torch.linalg.vector_norm(
        state.rays.direction.detach().to("cpu", torch.float64), dim=-1)
    finite = torch.isfinite(norms)
    # respawn-pending rays may carry stale directions: live lanes only
    live = state.rays.depth.detach().cpu() > 0
    if bool(live.any()):
        unit = (norms[live & finite] - 1.0).abs() < 1e-3
        out["live_direction_unit_frac"] = float(
            unit.to(torch.float64).mean())
    return out


def assert_state_finite(state: FrameState) -> None:
    """Raise FloatingPointError naming every ray-state tensor that went
    non-finite."""
    bad = {k: v for k, v in state_health(state).items()
           if k.endswith("finite_frac") and v < 1.0}
    if bad:
        raise FloatingPointError(f"non-finite ray state: {bad}")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _tensors(getattr(x, name))


def nan_guard(fn):
    """Wrap a step function so that a NaN or Inf in any tensor of its
    output (tuples, dicts and dataclasses of tensors included) raises
    FloatingPointError. A debugging aid: a host sync a call."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        for t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"NaN/Inf in step output tensor shape={tuple(t.shape)}")
        return out
    return wrapped
