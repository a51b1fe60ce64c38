"""The (tiles, samples) mesh over processes (port of
``raytracingpbr_tpu/parallel/mesh.py``).

The JAX package lays a ``Mesh`` of devices over two axes: pixel tiles (the
hot axis; the forward render needs no communication along it) and sample
ranks (each renders a share of the spp budget, summed at the end). Here a
:class:`Mesh` is ``tiles x samples`` ranks laid over the processes of a
``torch.distributed`` group. Ranks are numbered row-major, so rank ``r``
is tile ``r // samples``, sample rank ``r % samples``; each process owns a
contiguous block of ``tiles * samples / world_size`` ranks and runs them
on its one device. One process can so stand in for JAX's eight virtual
CPU devices, and two processes hold four ranks each.

Collectives (:func:`all_gather_rows`) gather every process's rows in
process order, and the callers combine them in mesh-rank order. A sum
is therefore never left to a backend's all-reduce order, and a render's
bits do not depend on how the ranks are spread over processes.

Transport: NCCL gathers CUDA tensors on the card. Gloo gathers host
tensors only, so a gloo group stages a CUDA tensor through host memory
and back. That is the case of two processes that share one card, which
NCCL refuses. Only the gathered values cross the host: the framebuffer
once at display time, a reprojection refresh's state, and the train
step's gradient (a few hundred floats for the Cornell scene). The
rendering itself stays on the card. A collective that fails raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

# Canonical axis names: "tiles" splits the pixels (no communication in the
# forward render), "samples" splits the spp budget (partial sums).
TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``tiles x samples`` mesh ranks over the processes of ``group``
    (None: this process alone holds every rank)."""

    tiles: int
    samples: int = 1
    group: Any = None

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: self.tiles, SAMPLE_AXIS: self.samples}

    @property
    def size(self) -> int:
        return self.tiles * self.samples

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def coords(self, r: int) -> Tuple[int, int]:
        """Mesh rank -> (tile, sample rank)."""
        return divmod(r, self.samples)

    def ranks_of(self, process: int) -> range:
        per = self.size // self.world
        return range(process * per, (process + 1) * per)

    def local_ranks(self) -> range:
        """The mesh ranks this process runs, ascending."""
        return self.ranks_of(self.rank)

    def tiles_of(self, process: int) -> List[int]:
        """The tiles whose pixels a process renders, ascending (a tile
        whose sample ranks span several processes is theirs alike)."""
        return sorted({r // self.samples for r in self.ranks_of(process)})

    def local_tiles(self) -> List[int]:
        return self.tiles_of(self.rank)


def make_mesh(tiles: Optional[int] = None, samples: int = 1,
              group=None) -> Mesh:
    """Lay a (tiles, samples) mesh over ``group``'s processes.

    ``group`` None takes the default group when ``torch.distributed`` is
    initialised with more than one process, else this process alone.
    ``tiles`` None puts every process on the tile axis (``world //
    samples``), as JAX's default puts every device there. The world size
    must divide ``tiles * samples``, and each process's block of ranks
    must hold whole tiles or lie inside one tile."""
    if (group is None and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    if tiles is None:
        assert world % samples == 0, (world, samples)
        tiles = world // samples
    size = tiles * samples
    assert tiles >= 1 and samples >= 1, (tiles, samples)
    assert size % world == 0, (tiles, samples, world)
    per = size // world
    assert per % samples == 0 or samples % per == 0, (tiles, samples, world)
    return Mesh(tiles, samples, group)


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Join a ``torch.distributed`` group of ``num_processes`` (nothing to
    do for one process).

    ``coordinator_address``: ``host:port`` of rank 0's store (a
    ``tcp://`` init method), or an init-method URL as it is (``tcp://...``
    or ``file://...``, a file store that needs no port). ``backend``
    defaults to ``nccl`` where the process renders on a card and to
    ``gloo`` on the CPU; an explicit one overrides it. Under NCCL the
    process takes card ``process_id % device_count`` as its current
    device."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (equal shapes) concatenated along dim 0 in
    process order, on ``x``'s device; ``x`` itself without a group. A
    gloo group stages a CUDA tensor through host memory (module
    docstring)."""
    if mesh.group is None:
        return x
    staged = (x.device.type == "cuda"
              and dist.get_backend(mesh.group) != "nccl")
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
