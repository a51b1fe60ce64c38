"""Speed-of-light accounting for the march kernels (port of
``raytracingpbr_tpu/utils/speedlight.py``; the port keeps its own copy of
the flop model and imports nothing of the JAX package).

1. :func:`march_flops_per_iter` — the JAX package's minimal-algorithmic
   flop count of one march trip of one lane (every elementwise op, sqrt
   and sin 1, an FMA 2). libdevice's ``sinf`` is tens of instructions, so
   for the bunny a bound built on this count is a lower bound on time.
2. :func:`measure_vpu_peak` — the JAX name is kept: on the H100 it is the
   measured FP32 FFMA roof, through kernel K2 (``kernels/fma_kernel``).
3. :func:`march_utilization` — one budgeted march through the kernels,
   timed on the card, with the lane-trips it needed and the ones the card
   executed (:func:`warp_executed`), and
   :func:`march_bound`, the least time the card could take for the same
   work.

A warp runs in lock step. In K1a and K1b a thread keeps one lane for the
call, so a warp executes 32 lanes times the trips of its longest lane
(:func:`warp_executed`). K1c and K1d keep a persistent pool of slots and
count what they run themselves (``march_kernel.march_resumable_cuda``'s
``counts``): the lane slots of their warps' march steps, and MLP
evaluations (queue entries, with a warp's padding), which :func:`mlp_work`
holds against the lane-trips that needed the MLP. The TPU's (8, 128)
tiles and chunk rounding have no counterpart here. The published peaks are
those of one H100 SXM at its 700 W limit (NVIDIA's data sheet): 67
TFLOP/s FP32, 495 TFLOP/s TF32 (dense), 3.35 TB/s.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..config import RenderConfig
from ..core.device import resolve
from ..kernels import fma_kernel, march_kernel
from ..ops import march as marchlib
from ..ops import sdf as sdflib
from ..ops.sdf import SHAPE

H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
H100_BYTES_PER_S = 3.35e12
WARP = 32

# --- static flop model (the JAX package's constants) -------------------------

_SHAPE_FLOPS = {
    int(SHAPE.NONE): 0,
    int(SHAPE.SPHERE): 7,
    int(SHAPE.BOX): 20,
    int(SHAPE.CYLINDER): 15,
    int(SHAPE.CONE): 8,
    int(SHAPE.PLANE): 1,
}
# the sin-MLP bunny: input layer 48 FMA + 16 sin; two hidden layers of
# 256 FMA + 16 sin + 16 residual adds (the second + 16 muls); output 16
# FMA + add; the support test r (7) + select (1)
_BUNNY_FLOPS = (48 * 2 + 16) + 2 * (256 * 2 + 16 + 16) + 16 + (16 * 2 + 1) + 8
_XFORM_PERM = 3 + 3 + 3
_XFORM_MAT = 3 + 3 + 9 * 2
_COMBINE = 4
_LOOP_OVERHEAD = 34
_ESCAPE_BOUND_EXTRA = 8

# Of a bunny lane-trip's flops, all but the support test run only inside
# the unit sphere; of those, the two 16 x 16 contractions are K1d's tensor
# core work, which its 3xTF32 split runs three times.
_BUNNY_SUPPORT = 8
BUNNY_MLP_FLOPS = _BUNNY_FLOPS - _BUNNY_SUPPORT
BUNNY_CONTRACTION_FLOPS = 2 * 256 * 2
TF32_PASSES = 3

# bytes a lane moves once: origin and direction in, the eight outputs out
# (t, index, fin, w, s, d, done 4 bytes, hit 1); the gate adds 1 and the
# resume inputs 16
_LANE_BYTES = 24 + 29


def march_flops_per_iter(scene, cfg: Optional[RenderConfig] = None) -> int:
    """Minimal-algorithmic flops of ONE march trip for ONE lane (the MLP
    counted on every trip, as the JAX package counts it)."""
    total = _LOOP_OVERHEAD
    if cfg is not None and cfg.escape_bound:
        total += _ESCAPE_BOUND_EXTRA
    for i, t in enumerate(scene.shape_types):
        perm = scene.rot_perm[i] if scene.rot_perm else None
        total += _XFORM_PERM if perm is not None else _XFORM_MAT
        total += _BUNNY_FLOPS if t == SHAPE.BUNNY else _SHAPE_FLOPS[int(t)]
        total += _COMBINE
    return total


# --- the measured FP32 roof --------------------------------------------------

# (threads, iters, chains, unroll): each about 7e10 flops (~1 ms at the
# published peak); 132 SMs x 2048 resident threads where the chains' 8-16
# registers allow it, half that for 32 chains
FMA_CONFIGS = ((132 * 2048, 4096, 8, 4), (132 * 2048, 2048, 16, 4),
               (132 * 1024, 2048, 32, 4), (132 * 1024, 8192, 32, 1))


def _measure_fma_config(threads: int, iters: int, chains: int, unroll: int,
                        reps: int = 5) -> float:
    """Flops/s of K2 at one configuration: CUDA events around ``reps``
    launches after a warm-up."""
    x = torch.full((threads,), 0.7, dtype=torch.float32,
                   device=resolve("cuda"))
    fma_kernel.fma_chains(x, iters, chains, unroll)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fma_kernel.fma_chains(x, iters, chains, unroll)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / reps
    return threads * iters * chains * unroll * 2 / seconds


@functools.lru_cache(maxsize=1)
def fma_sweep() -> dict:
    """Flops/s of K2 at each of :data:`FMA_CONFIGS` (measured once a
    process; ``fma_sweep.cache_clear()`` measures again)."""
    return {c: _measure_fma_config(*c) for c in FMA_CONFIGS}


def measure_vpu_peak() -> float:
    """Measured FP32 FFMA roof of the card in flops/s: the best of
    :func:`fma_sweep`. Raises without a card."""
    return max(fma_sweep().values())


# --- march accounting -------------------------------------------------------


def warp_executed(fin: torch.Tensor) -> int:
    """Lane-trips the card executes for per-lane trip counts ``fin``: each
    warp of 32 consecutive lanes (the last one padded with idle lanes) runs
    32 lanes for the trips of its longest lane."""
    pad = (-fin.shape[0]) % WARP
    f = torch.cat([fin.to(torch.int64),
                   torch.zeros(pad, dtype=torch.int64, device=fin.device)])
    return int(f.reshape(-1, WARP).amax(dim=1).sum()) * WARP


def support_lane_trips(scene, origin, direction, cfg: RenderConfig,
                       active=None, init=None, plain: Optional[list] = None):
    """``(inside, warp_inside)`` for one budgeted march, counted by the
    plain march on the same inputs: the (lane, bunny) trips whose point
    lies inside a bunny's unit sphere, where the MLP runs, and the
    lane-trips of warps of 32 consecutive lanes with at least one such lane
    (32 each: what a march that keeps a lane on one thread and runs the MLP
    for the whole warp would run). Both 0 for a scene without the bunny.
    For the work accounting only. ``plain``: a list to which the plain
    march's result is appended (with a bunny), so that a caller holding a
    kernel against the plain march runs it once."""
    bunnies = [i for i, t in enumerate(scene.shape_types)
               if t == SHAPE.BUNNY]
    counts = torch.zeros(2, dtype=torch.int64, device=origin.device)
    if not bunnies:
        return 0, 0
    pad = (-origin.shape[0]) % WARP

    def on_trip(pos, live):
        for i in bunnies:
            p = sdflib.to_object_space(pos, scene.position[i],
                                       scene.matrix[i],
                                       scene.local_offset[i])
            r = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
                           + p[:, 2] * p[:, 2])
            inside = live & ~(r > 1.0)
            warps = torch.cat([inside, inside.new_zeros(pad)]).reshape(
                -1, WARP).any(dim=1)
            counts[0] += inside.sum()
            counts[1] += warps.sum() * WARP

    res = marchlib.march_resumable_plain(scene, origin, direction, cfg,
                                         active, init, on_trip=on_trip)
    if plain is not None:
        plain.append(res)
    return int(counts[0]), int(counts[1])


def mlp_work(support: int, executed: int) -> dict:
    """The bunny MLP's work in one march: ``support`` (lane, bunny) trips
    needed it (:func:`support_lane_trips`), the kernel ran ``executed``
    evaluations (its count: queue entries with a warp's padding). Raises
    if the kernel ran fewer than were needed: it skipped an MLP."""
    if executed < support:
        raise AssertionError(f"the kernel ran {executed} MLP evaluations "
                             f"for {support} needed")
    return {"support_lane_iters": support,
            "mlp_lane_iters_executed": executed,
            "mlp_padding_pct": (100.0 * (executed / support - 1.0)
                                if support else 0.0)}


def march_bound(scene, cfg: RenderConfig, fin: torch.Tensor, support: int,
                active=None, init=None) -> dict:
    """The least time the card could take for one budgeted march's work.

    Operations: the needed lane-trips (sum of ``fin``) times
    :func:`march_flops_per_iter`, with the bunny's MLP counted only on the
    ``support`` lane-trips inside its unit sphere. With ``cfg.bunny_mxu``
    (K1d) the two hidden contractions go to the TF32 rate, three passes,
    beside the rest at the FP32 rate: the pipes run side by side, so the
    slower of the two is the operations' time. Bytes: each lane's inputs
    read once and its outputs written once, over 3.35 TB/s. The bound is
    the larger of the two times."""
    n = fin.shape[0]
    needed = int(fin.to(torch.int64).sum())
    n_bunny = sum(1 for t in scene.shape_types if t == SHAPE.BUNNY)
    flops = ((march_flops_per_iter(scene, cfg) - n_bunny * BUNNY_MLP_FLOPS)
             * needed + BUNNY_MLP_FLOPS * support)
    tc_flops = BUNNY_CONTRACTION_FLOPS * support if cfg.bunny_mxu else 0
    ops_s = max((flops - tc_flops) / H100_FP32_FLOPS,
                tc_flops * TF32_PASSES / H100_TF32_FLOPS)
    nbytes = n * (_LANE_BYTES + (1 if active is not None else 0)
                  + (16 if init is not None else 0))
    bytes_s = nbytes / H100_BYTES_PER_S
    return {"flops": flops, "tensor_core_flops": tc_flops, "bytes": nbytes,
            "lane_iters_needed": needed, "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def executed_counts(scene, origin, direction, cfg: RenderConfig,
                    active=None, init=None):
    """``(lane-trips executed, MLP evaluations)`` that K1c or K1d runs on
    these inputs, from one launch with its ``counts``: 32 for each warp and
    march step, and the queue entries the MLP ran, with a warp's padding.
    For the work accounting only."""
    counts = torch.zeros((2,), dtype=torch.int64, device=origin.device)
    march_kernel.march_resumable_cuda(scene, origin, direction, cfg,
                                      active=active, init=init, counts=counts)
    return int(counts[1]), int(counts[0])


def march_utilization(scene, origin, direction, cfg: RenderConfig,
                      active=None, init=None, reps: int = 10) -> dict:
    """Time one budgeted march (``cfg.max_raymarch`` trips) through the
    kernel the port dispatches it to, on CUDA tensors, and report its work
    against K2's roof and its bound (:func:`march_bound`).

    ``utilization_pct`` is the needed work's achieved rate (support-counted
    flops over the measured time) over the measured roof;
    ``fp32_peak_pct`` the same over the published 67 TFLOP/s;
    ``divergence_tax_pct`` the share of executed lane-trips that no lane
    needed: as K1c and K1d count them (:func:`executed_counts`),
    :func:`warp_executed` for K1a and K1b. For the bunny, :func:`mlp_work`
    of the kernel's MLP count, and ``mlp_warp_lane_iters``, what a
    warp-per-32-lanes MLP would run on the same inputs."""
    if not origin.is_cuda:
        raise ValueError("march_utilization times the card: CUDA tensors")
    run = lambda: marchlib.march_resumable(scene, origin, direction, cfg,
                                           active=active, init=init)
    res = run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    support, warp_support = support_lane_trips(scene, origin, direction, cfg,
                                               active, init)
    if march_kernel.variant(scene, cfg) in ("k1c", "k1d"):
        executed, mlp_executed = executed_counts(scene, origin, direction,
                                                 cfg, active, init)
        mlp = mlp_work(support, mlp_executed)
    else:
        executed = warp_executed(res.fin)
        mlp = mlp_work(support, support)
    bound = march_bound(scene, cfg, res.fin, support, active, init)
    peak = measure_vpu_peak()
    achieved = bound["flops"] / (ms / 1e3)
    needed = bound["lane_iters_needed"]
    return {
        "march_ms": ms,
        "lane_iters_executed": executed,
        "lane_iters_needed": needed,
        **mlp,
        "mlp_warp_lane_iters": warp_support,
        "flops_per_iter": march_flops_per_iter(scene, cfg),
        "achieved_gflops": achieved / 1e9,
        "roof_gflops": peak / 1e9,
        "utilization_pct": 100.0 * achieved / peak,
        "fp32_peak_pct": 100.0 * achieved / H100_FP32_FLOPS,
        "divergence_tax_pct": 100.0 * (1.0 - needed / max(executed, 1)),
        **bound,
        "bound_share_pct": 100.0 * bound["bound_ms"] / ms,
    }
