"""Frame-granularity adaptive compaction (port of
``raytracingpbr_tpu/ops/compact.py``).

With ``cfg.adaptive_sampling`` a converged pixel is gated out of the march
(``ops/march``'s ``active``), but a warp of 32 lanes still runs while any
of its lanes is active. Keeping the persistent ``FrameState`` in an
actives-first lane order packs the converged pixels into warps that have
nothing to do.

The wavefront is lane-order-invariant: every draw is keyed on ``pixel_id``
(data, not the lane's position), a deposit lands in the lane's own row, and
the split-march carry (``march_state`` / ``march_cum``) moves with its
lane. So a compacted render gives every pixel the same bits as an
uncompacted one; only the time changes. Callers render with
``integrator.render_frame_tile`` over the returned ``pixel_id`` and
display through :func:`scatter_pixels`.

Each per-lane leaf is gathered with ``index_select`` in its own dtype. The
JAX package's (N, 28) packed block with bitcast ints was a TPU gather
workaround and has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.types import FrameState, Rays


def _permute(state: FrameState, perm: torch.Tensor) -> FrameState:
    """Every per-lane leaf of ``state`` gathered by ``perm`` (``frame``
    kept)."""
    take = lambda v: v.index_select(0, perm)
    rays = Rays(*(take(getattr(state.rays, f.name))
                  for f in dataclasses.fields(Rays)))
    return state.replace(rays=rays, **{
        f.name: take(getattr(state, f.name))
        for f in dataclasses.fields(FrameState)
        if f.name not in ("rays", "frame")})


def actives_first_perm(active: torch.Tensor) -> torch.Tensor:
    """Stable counting partition, active lanes first: ``perm[new] = old``
    (int64)."""
    act = active.to(torch.int64)
    n_act = act.sum()
    pos = torch.where(act == 1, torch.cumsum(act, 0) - 1,
                      n_act + torch.cumsum(1 - act, 0) - 1)
    return torch.empty_like(pos).scatter_(
        0, pos, torch.arange(pos.shape[0], device=pos.device))


def compact_frame_state(state: FrameState, pixel_id: torch.Tensor,
                        noise_threshold: float
                        ) -> Tuple[FrameState, torch.Tensor]:
    """Permute the persistent state so that the noisy (active) pixels lead.
    ``pixel_id`` is the current lane -> pixel map (``arange`` for a fresh
    state); returns the permuted state and map."""
    perm = actives_first_perm(state.noise > noise_threshold)
    return _permute(state, perm), pixel_id.index_select(0, perm)


def uncompact_frame_state(state: FrameState, pixel_id: torch.Tensor
                          ) -> FrameState:
    """The state in raster lane order (lane i = pixel i): the order of
    checkpoints and of every consumer that does not compact."""
    inv = torch.empty_like(pixel_id).scatter_(
        0, pixel_id, torch.arange(pixel_id.shape[0],
                                  device=pixel_id.device,
                                  dtype=pixel_id.dtype))
    return _permute(state, inv)


def scatter_pixels(pixels, pixel_id, cfg) -> np.ndarray:
    """Invert the lane -> pixel map for display: the flat raster-order
    (N, 3) numpy array."""
    px = (pixels.detach().cpu().numpy() if isinstance(pixels, torch.Tensor)
          else np.asarray(pixels))
    pid = (pixel_id.cpu().numpy() if isinstance(pixel_id, torch.Tensor)
           else np.asarray(pixel_id))
    out = np.empty((cfg.num_pixels, 3), px.dtype)
    out[pid] = px
    return out
