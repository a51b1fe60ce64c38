"""Sharded rendering: pixel tiles and sample ranks over a :class:`Mesh`
(port of ``raytracingpbr_tpu/parallel/render.py``).

A process renders the pixels of the tiles it owns; the counter RNG is
keyed on the GLOBAL pixel id, so every layout renders the same pixels as
the unsharded render. A process's ranks share its one device, so their
lanes run as one batch: the pixels of each rank's tile, each lane with
its rank's sample ids. Every lane's arithmetic is its own, so the batch
changes no bit.

Combination is in a fixed order (``mesh.all_gather_rows``): the sample
ranks' partial sums are gathered and added in sample-rank order, and the
tiles are assembled in tile order. A tiles-only mesh therefore gives
``render_image`` / ``render_frame``'s bits, and no mesh's bits depend on
how its ranks are spread over processes.

Frame states are kept as this process's rows: the pixel-major leaves of
its tiles in (tile, slot) order (``shard_frame_state``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import RenderConfig
from ..core.types import Camera, FrameState, Rays
from ..ops import integrator as integ
from ..ops import post as postlib
from ..ops import reproject as reprojectlib
from ..ops.ibl import Environment
from ..ops.scene import Scene
from .mesh import Mesh, all_gather_rows


def tile_pixel_ids(ti: int, n: int, tiles: int, layout: str,
                   device=None) -> torch.Tensor:
    """Global pixel ids (int64) owned by tile ``ti``.

    ``contiguous``: the block ``[ti*n/tiles, (ti+1)*n/tiles)``.
    ``strided``: ``ti, ti+tiles, ...``: interleaves scanlines over the
    tiles, which evens out the march depth between them (sky against deep
    geometry; ``parallel/scaling.measure`` reports the imbalance)."""
    per = n // tiles
    k = torch.arange(per, dtype=torch.int64, device=device)
    if layout == "strided":
        return ti + k * tiles
    return ti * per + k


def unshard_pixels(flat: torch.Tensor, tiles: int,
                   layout: str) -> torch.Tensor:
    """Rows of ``flat`` in (tile, slot) order -> image-flat (pixel id)
    order."""
    if layout != "strided":
        return flat
    per = flat.shape[0] // tiles
    return (flat.reshape(tiles, per, *flat.shape[1:]).transpose(0, 1)
            .reshape(flat.shape))


def shard_pixels(flat: torch.Tensor, tiles: int,
                 layout: str) -> torch.Tensor:
    """Inverse of :func:`unshard_pixels`: ``out[ti*per + k] = flat[ti +
    k*tiles]`` under ``strided``."""
    if layout != "strided":
        return flat
    per = flat.shape[0] // tiles
    return (flat.reshape(per, tiles, *flat.shape[1:]).transpose(0, 1)
            .reshape(flat.shape))


def local_pixel_ids(mesh: Mesh, n: int, layout: str,
                    device=None) -> torch.Tensor:
    """The pixel ids of this process's rows, in (tile, slot) order."""
    return torch.cat([tile_pixel_ids(ti, n, mesh.tiles, layout, device)
                      for ti in mesh.local_tiles()])


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's rows of a global (tile, slot)-ordered array."""
    tiles = mesh.local_tiles()
    per = x.shape[0] // mesh.tiles
    return x[tiles[0] * per:(tiles[-1] + 1) * per]


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's rows -> the global (tile, slot)-ordered array, on
    every process. A tile held by several processes (its sample ranks
    spread over them) is taken from the first."""
    if mesh.group is None:
        return x
    parts = all_gather_rows(mesh, x).reshape(mesh.world, -1,
                                             *x.shape[1:])
    per = x.shape[0] // len(mesh.local_tiles())
    blocks = {}
    for p in range(mesh.world):
        for j, ti in enumerate(mesh.tiles_of(p)):
            blocks.setdefault(ti, parts[p, j * per:(j + 1) * per])
    return torch.cat([blocks[ti] for ti in range(mesh.tiles)])


def map_rows(state: FrameState, fn: Callable) -> FrameState:
    """``fn`` over the pixel-major leaves of a frame state (all but
    ``frame``)."""
    rays = Rays(*(fn(getattr(state.rays, f.name))
                  for f in dataclasses.fields(Rays)))
    return state.replace(rays=rays, **{
        f.name: fn(getattr(state, f.name))
        for f in dataclasses.fields(FrameState)
        if f.name not in ("rays", "frame")})


def _to_image(flat: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Flat x-major (W*H, 3) -> (H, W, 3), row 0 at the top."""
    img = flat.reshape(cfg.width, cfg.height, 3).permute(1, 0, 2)
    return torch.flip(img, dims=(0,))


def render_image_sharded(scene: Scene, env: Environment, cam: Camera,
                         cfg: RenderConfig, mesh: Mesh,
                         spp: Optional[int] = None,
                         tonemapped: bool = True,
                         layout: str = "contiguous",
                         **trace_kw) -> torch.Tensor:
    """Offline still over (tiles, samples): ``render_image``'s megakernel
    samples, the pixels split over the tiles (``layout``), the spp budget
    over the sample ranks. Sample rank ``si`` draws the global sample ids
    ``si*spp_local + k``; the camera ray comes from
    ``rng.sampler4(cfg.low_discrepancy)`` as in ``render_image`` (the JAX
    function draws ``uniform4`` whatever the flag). ``trace_kw`` go to
    ``megakernel_trace``. Returns the full (H, W, 3) image on every
    process, row 0 at the top."""
    n = cfg.num_pixels
    spp = spp if spp is not None else cfg.samples_per_pixel
    tiles, samples = mesh.tiles, mesh.samples
    assert n % tiles == 0, (n, tiles)
    assert spp % samples == 0, (spp, samples)
    spp_local, per = spp // samples, n // tiles
    dev = scene.device
    ranks = mesh.local_ranks()
    pixel_id = torch.cat([tile_pixel_ids(r // samples, n, tiles, layout,
                                         dev) for r in ranks])
    first = {r % samples * spp_local for r in ranks}
    if len(first) == 1:
        first = first.pop()
    else:
        first = torch.cat([torch.full((per,), r % samples * spp_local,
                                      dtype=torch.int64, device=dev)
                           for r in ranks])
    acc = integ.sample_sum(scene, env, cam, cfg, pixel_id, first,
                           spp_local, **trace_kw)
    parts = all_gather_rows(mesh, acc).reshape(tiles, samples, per, 3)
    total = parts[:, 0]
    for si in range(1, samples):
        total = total + parts[:, si]
    flat = unshard_pixels(total.reshape(n, 3), tiles, layout) / spp
    if tonemapped:
        flat = postlib.tonemap(flat, cfg)
    return _to_image(flat, cfg)


def shard_frame_state(state: FrameState, mesh: Mesh,
                      layout: str = "contiguous") -> FrameState:
    """An image-order frame state (every pixel) -> this process's rows, in
    (tile, slot) order under ``layout``."""
    return map_rows(state, lambda x: local_rows(
        shard_pixels(x, mesh.tiles, layout), mesh))


def render_frame_sharded(scene: Scene, env: Environment, cam: Camera,
                         state: FrameState, cfg: RenderConfig, mesh: Mesh,
                         refreshing=False, exposure=1.0,
                         prev_cam: Optional[Camera] = None,
                         layout: str = "contiguous"):
    """One progressive frame of this process's rows (``render_frame`` over
    its tiles' pixel ids through ``render_frame_tile``). Returns
    ``(pixels, new_state)``, both this process's rows in (tile, slot)
    order; :func:`gather_image` assembles the image at display time.

    With ``cfg.reprojection`` and ``prev_cam``, a refresh warps the
    accumulator into the new view (``ops/reproject``). The warp's splat
    crosses tiles, so the state's pixel-major leaves are gathered and put
    in image order, warped, and this process's rows put back (under the
    strided layout, permuted first and back after): refresh-rate work."""
    n = cfg.num_pixels
    assert n % mesh.tiles == 0, (n, mesh.tiles)
    if cfg.reprojection and prev_cam is not None:
        if refreshing:
            full = map_rows(state, lambda x: unshard_pixels(
                gather_rows(x, mesh), mesh.tiles, layout))
            full = reprojectlib.reproject(full, prev_cam, cam, cfg)
            state = shard_frame_state(full, mesh, layout)
        refreshing = False  # the warp re-armed the state
    pixel_id = local_pixel_ids(mesh, n, layout, state.accum.device)
    return integ.render_frame_tile(scene, env, cam, state, cfg, pixel_id,
                                   refreshing=refreshing, exposure=exposure)


def gather_image(pixels: torch.Tensor, cfg: RenderConfig,
                 mesh: Optional[Mesh] = None,
                 layout: str = "contiguous") -> torch.Tensor:
    """Assemble the (H, W, 3) image, row 0 at the top, from this process's
    rows of a sharded frame (every process's, under a group): the one
    cross-process data movement of the forward path."""
    if mesh is not None:
        pixels = unshard_pixels(gather_rows(pixels, mesh), mesh.tiles,
                                layout)
    return _to_image(pixels, cfg)
