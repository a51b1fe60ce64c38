"""Scaling instrumentation for the sharded renderer (port of
``raytracingpbr_tpu/parallel/scaling.py``).

Two questions:

* **per-tile load imbalance**: the forward render has no communication
  along the tile axis, so what scaling loses is imbalance: tiles of sky
  finish their march loops early and wait for tiles of deep geometry.
  Each tile's frame is timed alone (``utils/profiling.time_fn``), so the
  numbers hold on a mesh of more ranks than cards.
* **end-to-end efficiency**: the unsharded frame against the sharded
  frame of the slowest process (over the group when the mesh spans
  several, as JAX times the whole mesh's program). Meaningful only with a
  card a rank; with more ranks than cards across the group (one process
  on one H100, processes sharing a card, or the CPU) the report says
  ``virtual`` and the imbalance is the number that counts.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core import rng as rnglib
from ..core.types import Camera, make_frame_state
from ..ops import camera as cameralib
from ..ops import integrator as integ
from ..ops import march as marchlib
from ..ops.ibl import Environment
from ..ops.scene import Scene
from ..utils.profiling import time_fn
from . import render as prender
from .mesh import Mesh


@dataclasses.dataclass
class TileStats:
    tile: int
    seconds: float          # steady-state seconds a frame, the tile alone
    march_iters: int        # trips of the tile's longest primary ray


@dataclasses.dataclass
class ScalingReport:
    tiles: List[TileStats]
    imbalance_pct: float    # (max - mean) / mean * 100 over tile times
    t_single: float         # unsharded frame, seconds
    t_sharded: float        # sharded frame, seconds (slowest process)
    efficiency_pct: float   # t_single / (n_tiles * t_sharded) * 100
    n_tiles: int
    virtual: bool           # more ranks than cards: efficiency not meaningful

    def table(self) -> str:
        """Markdown per-tile table."""
        mean = np.mean([t.seconds for t in self.tiles])
        lines = ["| tile | s/frame | vs mean | max march iters |",
                 "|---|---|---|---|"]
        for t in self.tiles:
            lines.append(f"| {t.tile} | {t.seconds*1e3:.2f} ms | "
                         f"{t.seconds/mean - 1:+.1%} | {t.march_iters} |")
        lines.append(f"\nLoad imbalance (max-mean)/mean: "
                     f"**{self.imbalance_pct:.1f}%**; sharded frame "
                     f"{self.t_sharded*1e3:.2f} ms vs single "
                     f"{self.t_single*1e3:.2f} ms"
                     + (" (virtual mesh — efficiency not meaningful)"
                        if self.virtual else
                        f"; scaling efficiency {self.efficiency_pct:.1f}%"))
        return "\n".join(lines)


def _group(mesh: Mesh):
    """The process group the mesh spans, or None for this process alone:
    the mesh's own, else the default group when it holds several."""
    if mesh.group is not None:
        return mesh.group
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def _across(group, seconds: float, dev: torch.device):
    """(the slowest process's ``seconds``, the distinct cards the group's
    processes render on): an all-reduce MAX on the backend's device and
    the gathered (hostname, CUDA device index) pairs; without a group,
    this process's seconds and this host's cards. The CPU has no card."""
    if group is None:
        return seconds, (torch.cuda.device_count() if dev.type == "cuda"
                         else 0)
    nccl = dist.get_backend(group) == "nccl"
    on = (torch.device("cuda", torch.cuda.current_device()) if nccl
          else torch.device("cpu"))
    t = torch.tensor([seconds], dtype=torch.float64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    card = ((socket.gethostname(), dev.index if dev.index is not None
             else torch.cuda.current_device())
            if dev.type == "cuda" else None)
    cards = [None] * dist.get_world_size(group)
    dist.all_gather_object(cards, card, group=group)
    return float(t.item()), len({c for c in cards if c is not None})


def measure(scene: Scene, env: Environment, cam: Camera, cfg: RenderConfig,
            mesh: Mesh, iters: int = 5,
            layout: str = "contiguous") -> ScalingReport:
    """Per-tile cost and end-to-end scaling of a frame on ``mesh`` under
    ``layout``, on the scene's device.

    Each tile's pixels are rendered alone (its global pixel ids, a fresh
    state: the work of its shard) and timed; its work proxy is the trip
    count of its longest primary ray, from one march of its sample-0
    camera rays. These per-tile numbers are this process's own. Across
    processes (the mesh's group, or a default group of several) every
    process calls this together: ``t_sharded`` is then the slowest
    process's, the same on all, and ``virtual`` counts the cards of the
    whole group."""
    n = cfg.num_pixels
    tiles = mesh.tiles
    assert n % tiles == 0, (n, tiles)
    per = n // tiles
    dev = scene.device

    stats: List[TileStats] = []
    for ti in range(tiles):
        pixel_id = prender.tile_pixel_ids(ti, n, tiles, layout, dev)
        sec = time_fn(lambda st: integ.render_frame_tile(
            scene, env, cam, st, cfg, pixel_id),
            make_frame_state(per, device=dev), warmup=2, iters=iters)
        u = rnglib.uniform4(pixel_id, 0, integ._S_CAMERA, cfg.seed)
        uv = cameralib.pixel_uv(pixel_id, cfg.width, cfg.height, u[0], u[1])
        rays = cameralib.get_ray(cam, uv, u[2], u[3])
        res = marchlib.march(scene, rays.origin, rays.direction, cfg,
                             differentiable=False)
        stats.append(TileStats(ti, sec, int(res.iters)))

    times = np.array([t.seconds for t in stats])
    imbalance = float((times.max() - times.mean()) / times.mean() * 100.0)

    t_single = time_fn(lambda st: integ.render_frame(
        scene, env, cam, st, cfg), make_frame_state(n, device=dev),
        warmup=2, iters=iters)
    state = prender.shard_frame_state(make_frame_state(n, device=dev), mesh,
                                      layout)
    t_shard = time_fn(lambda st: prender.render_frame_sharded(
        scene, env, cam, st, cfg, mesh, layout=layout), state, warmup=2,
        iters=iters)

    t_shard, cards = _across(_group(mesh), t_shard, dev)
    virtual = mesh.size > cards
    eff = float(t_single / (tiles * t_shard) * 100.0)
    return ScalingReport(stats, imbalance, t_single, t_shard, eff, tiles,
                         virtual)
