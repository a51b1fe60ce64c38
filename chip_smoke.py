#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises and exits non-zero):

0.  device: the card's name and power limit, torch / CUDA versions,
    CUDA_HOME, whether triton imports, TF32 matmuls off. No card: fail (no
    CPU fallback).
1.  build every kernel from ``raytracingpbr_tpu_torch/csrc``, one nvcc per
    source started together (march.cu: K1a, K1b, K1c; march_mxu.cu: K1d;
    speedlight.cu: K2), and print what ``-Xptxas -v`` says of each library
    and the persistent grid of K1c and K1d.
1b. K2 (the FP32 FMA roof) vs its plain version at a small ragged size
    and on the sweep's own inputs at each of its configurations (rtol
    1e-5: FFMA rounds once, the plain multiply and add twice, and the
    recurrence contracts), kernel and plain timed on the roof's
    configuration.
2.  K1a vs its plain PyTorch version on the same CUDA tensors at the Cornell
    path's shapes (480x480 primaries chained in budgets of 32 over 512
    trips; the mixed split-march state after 3 plain wavefront steps; an
    all-inactive gate; a ragged N): all eight outputs bit-equal. Times of
    each version, in turns, on the primaries and on the mixed state.
2b. K1c and K1b vs the plain version. K1c: bunny glass primaries at 960x540
    (chained budget-32 calls, at most 4), the mixed state after 3 wavefront
    steps of the bunny path at 1920x1080 (made on the card), the metal scene
    (omega 0.9), the scene animated to frame 60, the escape bound, a ragged
    N and an all-inactive gate. K1b: the engine (ROLLBACK_TO_ONE + CONE),
    scene_demo (ROLLBACK_TO_ONE + RELATIVE) and tokyo (ROLLBACK_HALF_UP +
    RELATIVE) configs and the escape bound, on 768x432 primaries and random
    rays. Bit-equal on all eight outputs. Times of each variant, kernel and
    plain, in turns.
2c. K1d (``cfg.bunny_mxu``, the MLP on the tensor cores) vs its plain
    version (the MLP in the matmul form) on the glass mixed state and on
    metal primaries at 1920x1080, chained, held to
    ``march.assert_march_close``: at least 99.9% of lanes agree on hit,
    equal index where both hit, t within rtol and atol 1e-3 wherever hit
    agrees save a decision one trip apart and at most one grazing lane
    in 10,000. The MLP alone on 2^20 points in the unit ball within
    1e-6 of a float64 evaluation on the host. K1d vs K1c on the metal
    primaries over the full 512-trip budget (hit agreement, |dt|). Times
    in turns: K1d and plain, then K1c and K1d.
3.  the Cornell main path: progressive wavefront frames of the full-PBR
    Cornell box (480x480, 4 steps per frame, 512-trip march in budgets of
    32, black sky, ACES then gamma) as ``bench.py`` times them: 1 + 3
    warm-up frames, 10 timed. K1a must launch 4 times a frame. Then one
    more frame whose four march calls' inputs are recorded (3e).
3f. K1b's paths at full width, as ``tools/bench_workloads.py`` runs them
    with 4 steps of one sample a frame: tokyo IBL (``scene_demo_scene``,
    the tokyo HDR sky, ``engine_camera``, ``tokyo_config``: 2880x1620,
    ROLLBACK_HALF_UP + RELATIVE) and engine (768x432, ROLLBACK_TO_ONE +
    CONE); each 1 + 3 warm-up frames and 10 timed with ms/frame,
    Msamples/s and peak memory, 4 K1b launches a frame and no other march
    kernel; then one more frame each whose four march calls are recorded.
3b. the bunny glass path at full width: 1920x1080, 4 steps per frame, the
    2048-trip march in budgets of 32, omega 0.5, the RELATIVE hit test, the
    synthetic HDR sky, the scene animated to frame 12 on the card; 1 + 3
    warm-up frames, 10 timed, then re-animated to frame 13 for one more
    frame. K1c must launch 4 times a frame. Then one more frame whose four
    march calls' inputs are recorded (3e).
3c. the metal bunny path at full width: ``metal_config()`` at 3840x2160, 4
    steps per frame, the 512-trip march in budgets of 32, omega 0.9, the
    HDR sky; with ``bunny_mxu`` off (K1c) and on (K1d) in turns off, on,
    on, off, each 1 + 3 warm-up frames and 10 timed; then one
    ``torch.profiler`` window of 3 frames each for the device idle share.
    4 launches a frame of the one kernel, none of the other. Then one more
    frame each whose march calls' inputs are recorded (3e).
3d. the metal path's budget-32 call at 3840x2160 on its state after 16
    steps (where its timed frames start): K1c bit-equal to the plain
    march, K1d within the march bar of 2c.
3e. the frames' own calls. First the four budget-32 march calls recorded
    in 3 (Cornell, K1a) and 3f (tokyo and engine, K1b): on each, bit-equal
    to the plain march on all eight outputs; the kernel's time a call and
    back to back (calls queued behind a sleep, so the host's share is
    hidden); lane-trips needed and executed by warps of 32 fixed lanes
    (the divergence tax); the bound and its share. Then the four calls
    recorded in 3b (glass, K1c; K1d on the same inputs) and 3c (metal,
    K1c and K1d, each from its own frame). On each: K1c bit-equal to the
    plain march, K1d within the march bar; the kernel's time; lane-trips
    needed and executed, MLP evaluations needed (the support) and run (the
    kernel's counts), and the bound; then the frame's sums.
4.  the ``wavefront_cornell_full`` golden rendered on the card: >= 35 dB.
4b. the ``wavefront_scene_demo`` golden on the card (K1b's path): >= 35 dB.
3g. the megakernel (``render_image``) on the Cornell full config at
    480x480, on ``bench.py``'s megakernel protocol: spp 1, untonemapped,
    sample_offset 0 as warm-up, then 1..6 timed ending in a sync;
    Msamples/s, ms/pass, the bounces the loop ran (K1a's launches a pass,
    one a bounce), host syncs a pass (``torch.cuda.set_sync_debug_mode``),
    peak memory; the same at the loop's exit check every 8 and 32 bounces;
    one ``torch.profiler`` pass (device busy, idle share, top kernels).
3h. the minimal Cornell megakernel at 512x512, ``diffuse_only`` (the
    offline app's ``cornell_minimal``): the same numbers.
3i. the glass bunny megakernel at 1920x1080 (``glass_config``, the scene
    animated to frame 12, the HDR sky), spp 1, ``bunny_mxu`` off (K1c) and
    on (K1d) in turns off, on, on, off: the same numbers, the bounce by
    which 99% of lanes had stopped, one profiled pass with K1c.
3j. the megakernel's own march calls, recorded in one pass of 3g and of
    3i: bounce 0, bounce 1 and the last bounce with a live lane, unsplit
    (512 and 2048 trips). K1a bit-equal to the plain march on the whole
    call, timed, with its bound, share and divergence tax; K1c bit-equal
    and K1d within the march bar on every 8th lane of the glass calls (and
    on the whole call where at most that many lanes are active), timed on
    the whole call and on the subset, bound, share and tax on the subset.
3k. all nine self-goldens (``models/goldens``, ``tests/golden_specs.py``'s
    sizes) through ``render_image`` on the card, each >= 35 dB against
    ``assets/goldens/<name>.png``, each through its march kernel alone
    (K1b: cornell_v3, scene_demo, tokyo; K1c: the bunny three).
3l. the offline renderer as a user runs it, in a subprocess: ``python3 -m
    raytracingpbr_tpu_torch.apps.offline --scene cornell --frames 1 --spp 1
    --scale 1 --out build/offline_smoke``; rc 0 and a 480x480 PNG of mean
    above 0.
5.  utilization (``bench.py``'s speed-of-light extra): K2's roof (one
    sweep, which ``march_utilization`` reads), then
    ``bench.py``'s Cornell march (480x480 primaries, one unsplit 512-trip
    march through K1a) and each kernel's budget-32 state (K1a: the Cornell
    mixed state; K1b: scene_demo's 768x432 primaries; K1c and K1d: the
    glass mixed state at 1920x1080 and the metal path's state at 3840x2160
    after 16 steps, where its timed frames start): lane-trips needed and
    executed, MLP evaluations needed and run, flops, achieved GFLOP/s,
    the share of K2's roof and of 67 TFLOP/s, and the bound.
7a. environment sampling (NEE/MIS): the alias tables of the engine, tokyo
    and glass skies and of ``bench.py:119-127``'s 64x32 sun sky, their
    sizes and build times.
7b. the engine (768x432) and tokyo (2880x1620) frames of 3f with
    ``env_sampling`` off and on, in turns off, on, on, off, on the same
    frame protocol (K1b twice a step with NEE: the bounce and the shadow
    rays); one profiled NEE frame each (device busy, idle share, top
    kernels); one more NEE frame each whose shadow calls are recorded.
7c. the megakernel with NEE on ``bench.py:88-108``'s pass protocol: the
    Cornell full box at 480x480 (``max_raytrace`` 128) under the sun sky
    (K1a bounces, K1b shadow rays); the glass bunny at 1920x1080 with K1c
    and K1d in turns off, on, on, off; ms/pass, Msamples/s, bounces, host
    syncs; one K1c glass pass whose shadow calls are recorded.
7d. the recorded shadow-march calls (engine and tokyo: four each; glass:
    bounces 0, 1 and the last with a live lane): K1b and K1c bit-equal to
    the plain march, K1d within the march bar; time, lane-trips, bound and
    share, launches a frame or a pass.
7e. ``tests/test_nee.py``'s statistical bars on the card at 64x64, 8 seeds
    x 8 spp: the sun-lit and glossy scenes' means within rel 0.25 and NEE
    variance below half the plain one; specular MIS below 0.6x the
    variance of diffuse-only NEE.
7f. the progressive daemon in a subprocess, ``--scene demo --nee``,
    twice (the second run resumes): its checkpoint equals a straight
    render of as many frames bit for bit; 6 frames straight equal 3, a
    checkpoint, a load and 3 more in ``accum`` and ``pixels``.

8a. scan-AD on ``bench.py:110-152``'s fwd+bwd protocol: Cornell full
    480x480, ``max_raytrace`` 8, spp 1, the MSE against zeros, the albedo
    gradient through ``parallel/train.render_pixels``; one warm-up step,
    4 timed ending in a sync: s/step, Msamples/s (pixels / s/step), peak
    memory, K1a's launches a step; every K1a call of one step bit-equal to
    the plain march.
8b. path replay at 128 bounces (``bench.py:196-207``), with the march
    checkpoint and without: the same numbers; the two gradients within
    rtol 1e-5, atol 1e-7 max; peak memory at 4, 16, 32 and 128 bounces
    both ways, and scan-AD's at 4 and 16: without the checkpoint the peak
    stays within 5% from 4 bounces to 16, scan-AD's grows over 1.5x; the
    K1a calls of one step without the checkpoint (the forward's
    and the backward's re-march) bit-equal to the plain march.
8c. replay + NEE at 128 bounces under the 64x32 sun sky
    (``bench.py:208-215``): the same numbers, K1a the bounces and K1b the
    shadow rays; every K1a and K1b call of one step bit-equal.
8d. replay equals scan-AD on the card: Cornell full 480x480, 12 bounces,
    the albedo and emission gradients within rtol 2e-4, atol 2e-6 max.
8e. the train step on the card: ``tests/test_parallel.py``'s albedo
    recovery at 16x16 (30 steps of Adam, cosine schedule from 0.08); then
    1 + 5 timed steps at full width (Cornell full 480x480, 8 bounces,
    ``material_only_filter``, dual buffer): s/step, peak memory; K1a on
    the updated scene bit-equal to the plain march; one step training the
    matrix at 64x64 (the permutation records dropped), after which K1a on
    the updated scene is bit-equal too.

Each path's launch counts are set to 0 just before it and read just after.
The last lines are the kernels' JSON record (K1a and K1b with their mean
call inside their frames, a call alone and back to back; K1c and K1d with
theirs; K1a, K1c and K1d with their launches a megakernel pass and their
3j calls' time, bound and share, K1b with its launches in the goldens;
K1b, K1c and K1d with their 7d shadow calls' time, bound, share and
launches; K1a and K1b with their launches a step on the gradient paths),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Imports no jax.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from raytracingpbr_tpu_torch import (HitCriterion, OmegaPolicy, RenderConfig,
                                     Roulette, make_camera)
from raytracingpbr_tpu_torch.apps import progressive
from raytracingpbr_tpu_torch.core import rng
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.io import checkpoint as ckpt
from raytracingpbr_tpu_torch.io.image import read_png
from raytracingpbr_tpu_torch.kernels import build, fma_kernel, march_kernel
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.models.goldens import GOLDENS, render_golden
from raytracingpbr_tpu_torch.ops import camera, ibl, integrator, march
from raytracingpbr_tpu_torch.ops import scene as scenelib
from raytracingpbr_tpu_torch.ops.integrator import (render_frame,
                                                    render_image,
                                                    render_image_progressive)
from raytracingpbr_tpu_torch.ops.sdf import SHAPE, BunnyMLP, bunny_mlp_eval
from raytracingpbr_tpu_torch.parallel import train as ptrain
from raytracingpbr_tpu_torch.utils import speedlight
from raytracingpbr_tpu_torch.utils.metrics import psnr

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "assets", "goldens", "wavefront_cornell_full.png")
GOLDEN_DEMO = os.path.join(REPO, "assets", "goldens",
                           "wavefront_scene_demo.png")
FIELDS = ("t", "index", "hit", "fin", "w", "s", "d", "done")
CSRC = "raytracingpbr_tpu_torch/csrc"
TPU_KERNEL = "raytracingpbr_tpu/pallas/march_kernel.py"

# Sizes of the phases (the main paths' are the workloads' own).
BUNNY_RES = (1920, 1080)      # phase 3b, the K1c/K1d mixed state, K1d cmp
BUNNY_CMP_RES = (960, 540)    # K1c primaries
K1B_RES = (768, 432)          # K1b primaries
RANDOM_RAYS = 1 << 18         # K1b random rays
MLP_POINTS = 1 << 20          # K1d's MLP alone
TIMED_FRAMES = 10
# a sleep on the stream long enough (~10 ms) for the host to queue the
# back-to-back calls of device_ms behind it
SLEEP_CYCLES = 20_000_000
# K2's comparison with its plain version: (threads, iters, chains, unroll)
K2_CHECK = (132 * 256 + 3, 64)
# the megakernel: bench.py's timed passes (3g, 3h); glass passes a run (3i,
# four runs); every GLASS_SUBSET-th lane of a glass call for the plain
# march (3j: 2,073,600 / 8 = 259,200 lanes)
MEGA_PASSES = 6
GLASS_PASSES = 1
GLASS_SUBSET = 8
GLASS_CALLS = f"glass megakernel, every {GLASS_SUBSET}th lane"
# NEE statistics (7e): tests/test_nee.py's scenes at this size, seeds and
# samples per pixel; the progressive daemon's two runs (7f)
NEE_STATS_RES = (64, 64)
NEE_SEEDS = 8
NEE_SPP = 8
PROGRESSIVE_MINUTES = 0.05
# gradients (8a-8c): bench.py's timed fwd+bwd steps after one warm-up;
# the train step (8e): the albedo recovery's size and steps, then timed
# steps at full width
GRAD_STEPS = 4
RECOVERY_RES = (16, 16)
RECOVERY_STEPS = 30
TRAIN_TIMED_STEPS = 5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main_config():
    """bench.py's headline configuration."""
    return cornell.full_config().replace(samples_per_frame=4,
                                         max_raytrace=512,
                                         quality_per_sample=0.8)


def bunny_config():
    """The bunny glass animation as the reference's workload table runs it:
    1920x1080, 4 steps a frame of one sample each."""
    return bunny.glass_config().replace(resolution=BUNNY_RES,
                                        samples_per_frame=4,
                                        samples_per_pixel=1)


def metal_config():
    """The metal bunny as the reference's workload table runs it: 3840x2160,
    4 steps a frame of one sample each."""
    return bunny.metal_config().replace(samples_per_frame=4,
                                        samples_per_pixel=1)


def k1b_paths(dev):
    """K1b's two paths as the reference's workload table runs them
    (``tools/bench_workloads.py``), 4 steps a frame of one sample each:
    {label: (scene, environment, camera, config)}."""
    one = dict(samples_per_frame=4, samples_per_pixel=1)
    return {
        "tokyo 2880x1620": (demo.scene_demo_scene(dev),
                            demo.tokyo_environment(device=dev),
                            demo.engine_camera(dev),
                            demo.tokyo_config().replace(**one)),
        "engine 768x432": (demo.engine_scene(dev),
                           demo.engine_environment(device=dev),
                           demo.engine_camera(dev),
                           demo.engine_config().replace(**one)),
    }


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs the card")
    log("[0] card:", card_line())
    log("[0] torch", torch.__version__, "cuda", torch.version.cuda,
        "devices", torch.cuda.device_count(),
        "name", torch.cuda.get_device_name(0))
    log("[0] CUDA_HOME", os.environ.get("CUDA_HOME"), "nvcc",
        build.nvcc_path())
    try:
        import triton
        log("[0] triton", triton.__version__)
    except ImportError as e:
        log("[0] triton not importable:", e)
    # the bunny's matmul form (normals, K1d's plain version) runs in full f32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the bunny MLP needs f32")
    return torch.device("cuda", 0)


def ptxas_summary(report: str) -> str:
    """Registers, shared memory and spills over a library's kernels, from
    its ``-Xptxas -v`` report."""
    regs, spills, smem = [], [], []
    for line in report.splitlines():
        if "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
            if "smem" in line:
                smem.append(int(line.split("bytes smem")[0].split()[-1]))
        if "spill stores" in line:
            spills.append(int(line.split("bytes spill stores")[0]
                              .split()[-1]))
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{max(smem, default=0)} bytes smem at most, spill stores "
            f"{min(spills)}-{max(spills)} bytes")


def phase_build():
    t0 = time.perf_counter()
    paths = build.build_all()
    march_kernel.load("march")
    march_kernel.load("march_mxu")
    fma_kernel.load()
    secs = time.perf_counter() - t0
    libs = ", ".join(os.path.relpath(p, REPO) for p in paths.values())
    log(f"[1] built {libs} in {secs:.2f} s (one nvcc per source, in parallel)")
    for name, label in (("march", "K1a-K1c"), ("march_mxu", "K1d"),
                        ("speedlight", "K2")):
        log(f"[1] ptxas {label} ({name}.cu): "
            f"{ptxas_summary(build.ptxas_report(name))}")
    for kind in ("k1c", "k1d"):
        per_sm, sms = march_kernel.pool_occupancy(kind)
        log(f"[1] {kind.upper()} persistent grid: {per_sm} blocks of "
            f"{march_kernel.POOL_SLOTS} slots per SM x {sms} SMs = "
            f"{per_sm * sms * march_kernel.POOL_SLOTS} slots")
    return secs


def device_ms(fn, reps=20):
    """The card's time per call of fn() when calls run back to back: CUDA
    events around ``reps`` calls queued behind a sleep on the stream, so
    the host's work per call (the wrapper, the launch) is hidden. For a
    call that launches one kernel, that kernel's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps=15):
    """Median wall time of fn() on the card, timed with CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(run_k, run_p, reps_k=15, reps_p=15):
    """Kernel and plain timed in turns k p p k after one warm-up each;
    returns (kernel ms, plain ms, the four medians)."""
    run_k(), run_p()
    ms = [median_ms(run_k, reps_k), median_ms(run_p, reps_p),
          median_ms(run_p, reps_p), median_ms(run_k, reps_k)]
    return (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2, ms


def phase_k2(dev):
    """K2 against its plain version (rtol 1e-5) on varied inputs at a small
    ragged size and on the sweep's own inputs at each of its
    configurations, then both timed on the roof's configuration (the sweep
    itself runs in phase 5)."""
    n, iters = K2_CHECK
    x = torch.rand(n, generator=torch.Generator().manual_seed(0)).to(dev)
    err = 0.0
    for chains, unroll in fma_kernel.SHAPES:
        got = fma_kernel.fma_chains(x, iters, chains, unroll)
        ref = fma_kernel.fma_chains_plain(x, iters, chains, unroll)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
        err = max(err, float((got - ref).abs().max()))
    log(f"[1b] K2 vs plain at {n} lanes x {iters} trips, every (chains, "
        f"unroll) of {fma_kernel.SHAPES}: within rtol 1e-5, max |err| "
        f"{err:.3e}")
    for threads, iters, chains, unroll in speedlight.FMA_CONFIGS:
        xs = torch.full((threads,), 0.7, dtype=torch.float32, device=dev)
        got = fma_kernel.fma_chains(xs, iters, chains, unroll)
        ref = fma_kernel.fma_chains_plain(xs, iters, chains, unroll)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
        err = max(err, float((got - ref).abs().max()))
    log(f"[1b] K2 vs plain on the sweep's inputs at every configuration of "
        f"{speedlight.FMA_CONFIGS}: within rtol 1e-5, max |err| {err:.3e}")
    cfg = speedlight.FMA_CONFIGS[1]
    threads, iters, chains, unroll = cfg
    xs = torch.full((threads,), 0.7, dtype=torch.float32, device=dev)
    k_ms, p_ms, ms = in_turns(
        lambda: fma_kernel.fma_chains(xs, iters, chains, unroll),
        lambda: fma_kernel.fma_chains_plain(xs, iters, chains, unroll), 5, 1)
    flops = threads * iters * chains * unroll * 2
    bound = flops / speedlight.H100_FP32_FLOPS * 1e3
    log(f"[1b] K2 at (threads, iters, chains, unroll) = {cfg}: kernel "
        f"{k_ms:.4f} ms ({flops / k_ms / 1e6:.1f} GFLOP/s), plain "
        f"{p_ms:.4f} ms (k p p k: {', '.join(f'{v:.4f}' for v in ms)}); "
        f"bound {bound:.4f} ms (operations)")
    return err, k_ms, p_ms, bound


def compare(scene, o, d, cfg, active=None, init=None):
    """Kernel vs plain on the same inputs; asserts all eight outputs are
    bit-equal. Returns (kernel result, max abs difference)."""
    k = march.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=active, init=init))
    p = march.march_resumable_plain(scene, o, d, cfg, active=active,
                                    init=init)
    bad = {name: int((a != b).sum()) for name, a, b in zip(FIELDS, k, p)}
    if any(bad.values()):
        lanes = torch.zeros_like(k.t, dtype=torch.bool)
        for a, b in zip(k, p):
            lanes |= a != b
        for j in lanes.nonzero()[:4, 0].tolist():
            log(f"lane {j}: origin {o[j].tolist()}, direction "
                f"{d[j].tolist()}, active "
                f"{None if active is None else bool(active[j])}, init "
                f"{None if init is None else [float(v[j]) for v in init]}; "
                f"kernel {[v[j].item() for v in k]}, plain "
                f"{[v[j].item() for v in p]}")
        raise AssertionError(f"lanes differ between kernel and plain march: "
                             f"{bad}")
    err = max((float((a - b).abs().max()) for a, b in zip(k, p)
               if a.dtype.is_floating_point and a.numel()), default=0.0)
    return k, err


def compare_close(scene, o, d, cfg, active=None, init=None):
    """K1d vs its plain version, held to ``march.assert_march_close``.
    Returns (kernel result, max |dt| on the lanes held to the tolerance,
    a note of the lanes it excused, split on hit, or let part in t)."""
    k = march.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=active, init=init))
    p = march.march_resumable_plain(scene, o, d, cfg, active=active,
                                    init=init)
    err, excused, split, apart = march.assert_march_close(
        scene, o, d, k, p, cfg)
    marching = int((apart & (k.done == 0) & (p.done == 0)).sum())
    note = (f"{split} lanes split on hit, {excused} excused (a trip apart "
            f"or gone from the scene), "
            f"{int(apart.sum())} grazing lanes apart in t ({marching} of "
            f"them still marching in both)")
    return k, err, note


def chain(scene, o, d, cfg, total, max_calls, cmp=compare):
    """Chained budget-B calls (B = ``cfg.max_raymarch``) of kernel and
    plain, each compared; stops at convergence, after ``total`` trips or
    after ``max_calls``. Returns (calls, max abs err, lanes unconverged)."""
    live = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    init, calls, err = None, 0, 0.0
    for _ in range(min(total // cfg.max_raymarch, max_calls)):
        k, e = cmp(scene, o, d, cfg, active=live, init=init)[:2]
        calls, err = calls + 1, max(err, e)
        live = live & (k.done == 0)
        init = (k.t, k.w, k.s, k.d)
        if not bool(live.any()):
            break
    return calls, err, int(live.sum())


def primaries(cfg, cam):
    dev = cam.lookfrom.device
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    u = rng.uniform4(pid, 0, 1, cfg.seed)
    uv = camera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = camera.get_ray(cam, uv, u[2], u[3])
    return rays.origin, rays.direction


def random_rays(n, seed, center, spread, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    o = torch.tensor(center) + spread * torch.randn((n, 3), generator=g)
    d = torch.randn((n, 3), generator=g)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return o.to(dev), d.to(dev)


def mixed_state(scene, env, cam, cfg, steps=3):
    """Rays and resume inits of the split march after ``steps`` wavefront
    steps from a fresh state (made on the scene's device)."""
    st = make_frame_state(cfg.num_pixels, device=scene.device)
    _, st = render_frame(scene, env, cam, st,
                         cfg.replace(samples_per_frame=steps))
    marching = st.march_cum > 0
    dflt = (cfg.march_t0, cfg.omega, 0.0, scenelib.MAX_DIS)
    init = tuple(torch.where(marching, st.march_state[:, j],
                             torch.full_like(st.march_state[:, j], v))
                 for j, v in enumerate(dflt))
    return st.rays.origin, st.rays.direction, init, int(marching.sum())


def phase_kernel_vs_plain(dev):
    cfg = main_config()
    scene = cornell.full_scene(dev)
    mcfg = cfg.replace(max_raymarch=cfg.march_split)
    o, d = primaries(cfg, cornell.full_camera(dev))

    # primaries, budget 32 chained over the 512-trip budget
    calls, err, unconv = chain(scene, o, d, mcfg, cfg.max_raymarch, 16)
    log(f"[2] primaries: {calls} chained budget-32 calls bit-equal; "
        f"{unconv} lanes unconverged after 512 trips")

    # mixed split-march state after 3 plain wavefront steps (on the CPU)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    mo, md, minit, n_flight = mixed_state(
        cornell.full_scene(cpu), cornell.sky(cpu), cornell.full_camera(cpu),
        cfg)
    mo, md = mo.to(dev), md.to(dev)
    minit = tuple(v.to(dev) for v in minit)
    _, e = compare(scene, mo, md, mcfg, init=minit)
    err = max(err, e)
    log(f"[2] mixed state ({n_flight} segments in flight, "
        f"{time.perf_counter() - t0:.1f} s of CPU steps): bit-equal")

    # all-inactive gate, ragged N
    live = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    k, e = compare(scene, o, d, mcfg, active=live)
    assert int(k.fin.sum()) == 0 and bool((k.done == 1).all())
    err = max(err, e)
    _, e = compare(scene, torch.cat([o, o[:1]]), torch.cat([d, d[:1]]),
                   mcfg)
    err = max(err, e)
    log("[2] all-inactive gate and ragged N=230401: bit-equal")

    # time each version on the fresh budget-32 primary march and on the
    # mixed state (the main path's shape), in turns
    for label, args in (("primaries", (o, d, None)),
                        ("mixed state", (mo, md, minit))):
        k_ms, p_ms, ms = in_turns(
            lambda: march_kernel.march_resumable_cuda(
                scene, args[0], args[1], mcfg, init=args[2]),
            lambda: march.march_resumable_plain(scene, args[0], args[1],
                                                mcfg, init=args[2]))
        log(f"[2] K1a budget-32 call, {label} at {o.shape[0]} lanes: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms (medians, in turns k p p "
            f"k: {', '.join(f'{v:.4f}' for v in ms)})")
    return err, k_ms, p_ms, (scene, mo, md, minit, mcfg)


def phase_k1c_vs_plain(dev):
    cfg = bunny_config()
    mcfg = cfg.replace(max_raymarch=cfg.march_split)
    glass, env = bunny.glass_scene(dev), bunny.glass_environment(device=dev)

    ccfg = mcfg.replace(resolution=BUNNY_CMP_RES)
    o, d = primaries(ccfg, bunny.camera(ccfg.width / ccfg.height, dev))
    calls, err, unconv = chain(glass, o, d, ccfg, cfg.max_raymarch, 4)
    log(f"[2b] K1c glass primaries {BUNNY_CMP_RES}: {calls} chained "
        f"budget-32 calls bit-equal, {unconv} lanes still marching")

    t0 = time.perf_counter()
    cam = bunny.camera(cfg.width / cfg.height, dev)
    mo, md, minit, n_flight = mixed_state(glass, env, cam, cfg)
    _, e = compare(glass, mo, md, mcfg, init=minit)
    err = max(err, e)
    log(f"[2b] K1c mixed state at {BUNNY_RES} ({n_flight} segments in "
        f"flight, {time.perf_counter() - t0:.1f} s of card steps): bit-equal")

    metal = bunny.metal_scene(dev)
    mtl = bunny.metal_config().replace(resolution=BUNNY_CMP_RES,
                                       max_raymarch=32)
    _, e, _ = chain(metal, o, d, mtl, mtl.max_raymarch * 2, 2)
    err = max(err, e)
    anim = bunny.animated_scene(glass, torch.tensor(60.0, device=dev))
    _, e = compare(anim, o, d, ccfg)
    err = max(err, e)
    _, e = compare(glass, o, d, ccfg.replace(escape_bound=True))
    err = max(err, e)
    k, e = compare(glass, o, d, ccfg,
                   active=torch.zeros(o.shape[0], dtype=torch.bool,
                                      device=dev))
    assert int(k.fin.sum()) == 0 and bool((k.done == 1).all())
    err = max(err, e)
    _, e = compare(glass, o[:-1], d[:-1], ccfg)
    err = max(err, e)
    log(f"[2b] K1c metal (omega 0.9, 2 calls), animated frame 60, escape "
        f"bound, all-inactive, ragged N={o.shape[0] - 1}: bit-equal")

    # time on the main path's shape: the mixed state at full width
    k_ms, p_ms, ms = in_turns(
        lambda: march_kernel.march_resumable_cuda(glass, mo, md, mcfg,
                                                  init=minit),
        lambda: march.march_resumable_plain(glass, mo, md, mcfg,
                                            init=minit), 15, 3)
    log(f"[2b] K1c budget-32 call on the mixed state at {mo.shape[0]} "
        f"lanes: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (k p p k: "
        f"{', '.join(f'{v:.4f}' for v in ms)})")
    return err, k_ms, p_ms, (glass, mo, md, minit, mcfg)


def phase_k1b_vs_plain(dev):
    cases = {
        "engine (ROLLBACK_TO_ONE + CONE)": (
            demo.engine_scene(dev), demo.engine_config()),
        "scene_demo (ROLLBACK_TO_ONE + RELATIVE)": (
            demo.scene_demo_scene(dev), demo.scene_demo_config()),
        "tokyo (ROLLBACK_HALF_UP + RELATIVE)": (
            demo.engine_scene(dev), demo.tokyo_config()),
        "engine + escape bound": (
            demo.engine_scene(dev),
            demo.engine_config().replace(escape_bound=True)),
    }
    err, times, states = 0.0, {}, {}
    ro, rd = random_rays(RANDOM_RAYS, 4, (0.0, -0.2, 3.5), 0.2, dev)
    for label, (scene, cfg) in cases.items():
        cfg = cfg.replace(resolution=K1B_RES)
        mcfg = cfg.replace(max_raymarch=32)
        assert march_kernel.variant(scene, mcfg) == "k1b"
        o, d = primaries(cfg, demo.engine_camera(dev))
        calls, e, unconv = chain(scene, o, d, mcfg, cfg.max_raymarch, 16)
        err = max(err, e)
        k, e = compare(scene, ro, rd, cfg.replace(max_raymarch=128))
        err = max(err, e)
        g = torch.Generator(device="cpu").manual_seed(1)
        act = (torch.rand(ro.shape[0], generator=g) < 0.5).to(dev)
        _, e = compare(scene, ro, rd, mcfg, active=act,
                       init=(k.t, k.w, k.s, k.d))
        err = max(err, e)
        k_ms, p_ms, _ = in_turns(
            lambda: march_kernel.march_resumable_cuda(scene, o, d, mcfg),
            lambda: march.march_resumable_plain(scene, o, d, mcfg), 15, 5)
        times[label] = (k_ms, p_ms)
        states[label] = (scene, o, d, None, mcfg)
        log(f"[2b] K1b {label}: {calls} chained budget-32 primary calls "
            f"({unconv} unconverged), random rays fresh + gated resume: "
            f"bit-equal; budget-32 call at {o.shape[0]} lanes: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return err, times, states


def phase_k1d_vs_plain(dev, glass_state):
    """K1d against its plain version (the matmul-form MLP), its MLP alone
    against float64, and against K1c."""
    glass, mo, md, minit, gcfg = glass_state
    mxu = gcfg.replace(bunny_mxu=True)
    assert march_kernel.variant(glass, mxu) == "k1d"
    _, err, note = compare_close(glass, mo, md, mxu, init=minit)
    log(f"[2c] K1d glass mixed state at {mo.shape[0]} lanes: within the "
        f"bar; {note}; max |dt| on the rest {err:.3e}")

    metal = bunny.metal_scene(dev)
    mcfg = bunny.metal_config().replace(resolution=BUNNY_RES)
    o, d = primaries(mcfg, bunny.camera(mcfg.width / mcfg.height, dev))
    calls, e, unconv = chain(metal, o, d,
                             mcfg.replace(max_raymarch=32, bunny_mxu=True),
                             mcfg.max_raymarch, 4, cmp=compare_close)
    err = max(err, e)
    log(f"[2c] K1d metal primaries {BUNNY_RES}: {calls} chained budget-32 "
        f"calls within the bar, {unconv} lanes still marching")
    k, e, note = compare_close(
        metal, o[:-1], d[:-1],
        mcfg.replace(max_raymarch=32, bunny_mxu=True, escape_bound=True))
    err = max(err, e)
    zero = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    k, _, _ = compare_close(metal, o, d, mcfg.replace(max_raymarch=32,
                                                      bunny_mxu=True),
                            active=zero)
    assert int(k.fin.sum()) == 0 and bool((k.done == 1).all())
    log(f"[2c] K1d escape bound + ragged N={o.shape[0] - 1} ({note}), "
        f"all-inactive: within the bar")

    # the MLP alone against float64 on the host
    g = torch.Generator().manual_seed(0)
    p = torch.randn((MLP_POINTS, 3), generator=g)
    p = (p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
         * torch.rand((MLP_POINTS, 1), generator=g) ** (1 / 3))
    got = march_kernel.bunny_mlp_mxu(metal, p.to(dev)).cpu().double()
    mlp64 = BunnyMLP(*(v.cpu().double() for v in metal.bunny))
    mlp_err = float((got - bunny_mlp_eval(mlp64, p.double())).abs().max())
    if not mlp_err < 1e-6:
        raise AssertionError(f"K1d MLP {mlp_err:.3e} from float64 (>= 1e-6)")
    log(f"[2c] K1d MLP alone on {MLP_POINTS} points in the unit ball: max "
        f"|err| {mlp_err:.3e} against float64 on the host (bar 1e-6)")

    # K1d vs K1c on the same rays over the full budget (probe_bunny_mxu)
    r_c = march.march(metal, o, d, mcfg)
    r_d = march.march(metal, o, d, mcfg.replace(bunny_mxu=True))
    agree = float((r_c.hit == r_d.hit).float().mean())
    both = r_c.hit & r_d.hit
    dt = (r_c.t - r_d.t).abs()[both]
    log(f"[2c] K1d vs K1c, metal primaries {BUNNY_RES}, 512 trips: hit "
        f"agree {agree * 100:.4f}%, |dt| on both-hit lanes max "
        f"{float(dt.max()):.2e} mean {float(dt.mean()):.2e}")

    k_ms, p_ms, ms = in_turns(
        lambda: march_kernel.march_resumable_cuda(glass, mo, md, mxu,
                                                  init=minit),
        lambda: march.march_resumable_plain(glass, mo, md, mxu,
                                            init=minit), 15, 3)
    log(f"[2c] K1d budget-32 call on the glass mixed state: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms (k p p k: "
        f"{', '.join(f'{v:.4f}' for v in ms)})")
    c_ms, d_ms, ms = in_turns(
        lambda: march_kernel.march_resumable_cuda(glass, mo, md, gcfg,
                                                  init=minit),
        lambda: march_kernel.march_resumable_cuda(glass, mo, md, mxu,
                                                  init=minit))
    log(f"[2c] K1c vs K1d on the same call, in turns (c d d c: "
        f"{', '.join(f'{v:.4f}' for v in ms)}): K1c {c_ms:.4f} ms, K1d "
        f"{d_ms:.4f} ms")
    return err, k_ms, p_ms


def check_frame(px, c0, c1):
    if not c1 > c0 > 0:
        raise AssertionError(f"accumulator alpha did not grow: {c0} -> {c1}")
    if not (bool(torch.isfinite(px).all()) and float(px.min()) >= 0.0
            and float(px.max()) <= 1.0):
        raise AssertionError("pixels not finite in [0, 1]")


def run_frames(scene, env, cam, cfg, kind, label, per_step=1):
    """bench.py's protocol from a fresh state: 1 + 3 warm-up frames, 10
    timed, ending in a sync; ``kind``'s kernel must launch ``per_step``
    times a step (2 with NEE: the bounce and the shadow rays) and no other
    march kernel at all. Returns (ms/frame, Msamples/s, launches,
    state)."""
    state = make_frame_state(cfg.num_pixels, device=scene.device)
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    for _ in range(3):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    c0 = float(state.accum[:, 3].sum())
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c1 = float(state.accum[:, 3].sum())
    launches = dict(march_kernel.LAUNCHES)
    bound = dict(march_kernel.BOUND_LAUNCHES)
    frames = 4 + TIMED_FRAMES
    expect = {k: per_step * steps * frames if k == kind else 0
              for k in launches}
    if launches != expect:
        raise AssertionError(f"{label}: expected {per_step * steps} {kind} "
                             f"launches per frame, got {launches} over "
                             f"{frames} frames")
    # with NEE (per_step 2) one launch a step is the shadow rays' bound one
    expect = {k: (per_step - 1) * steps * frames if k == kind else 0
              for k in bound}
    if bound != expect:
        raise AssertionError(f"{label}: expected {expect} escape-bound "
                             f"launches, got {bound}")
    check_frame(px, c0, c1)
    ms, msps = dt / TIMED_FRAMES * 1e3, (c1 - c0) / dt / 1e6
    log(f"{label}: first frame {first:.2f} s; {ms:.3f} ms/frame, "
        f"{msps:.4f} Msamples/s, {launches[kind]} {kind} launches in "
        f"{frames} frames, {bound[kind]} of them escape-bound")
    return ms, msps, launches[kind], state


def phase_main_path(dev):
    """The Cornell frames, then one more whose four march calls are
    recorded (3e)."""
    cfg = main_config()
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    ms, msps, n, state = run_frames(scene, env, cam, cfg, "k1a",
                                    "[3] main path 480x480")
    calls, _ = capture_frame(scene, env, cam, cfg, state)
    return n, ms, msps, (scene, calls)


def phase_k1b_paths(dev):
    """K1b's paths at full width (3f): tokyo 2880x1620 and engine 768x432,
    each 1 + 3 warm-up frames and 10 timed with 4 K1b launches a frame and
    no other march kernel, then one more frame whose four march calls are
    recorded (3e). Returns {label: (ms/frame, Msamples/s, launches, peak
    GiB, (scene, calls))}."""
    out = {}
    for label, (scene, env, cam, cfg) in k1b_paths(dev).items():
        assert march_kernel.variant(scene, cfg) == "k1b"
        torch.cuda.reset_peak_memory_stats()
        ms, msps, n, state = run_frames(scene, env, cam, cfg, "k1b",
                                        f"[3f] {label}")
        mem = torch.cuda.max_memory_allocated() / 2**30
        log(f"[3f] {label}: peak device memory {mem:.2f} GiB")
        calls, _ = capture_frame(scene, env, cam, cfg, state)
        out[label] = (ms, msps, n, mem, (scene, calls))
    return out


def phase_bunny_path(dev):
    cfg = bunny_config()
    base = bunny.glass_scene(dev)
    scene = bunny.animated_scene(base, torch.tensor(12.0, device=dev))
    env = bunny.glass_environment(device=dev)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    torch.cuda.reset_peak_memory_stats()
    ms, msps, n, state = run_frames(scene, env, cam, cfg, "k1c",
                                    f"[3b] bunny glass path {cfg.width}x"
                                    f"{cfg.height}")
    # re-animate on the card (full matrix path, nonzero offset), one frame
    scene13 = bunny.animated_scene(base, torch.tensor(13.0, device=dev))
    assert scene13.rot_perm == (None,)
    assert float(scene13.local_offset.abs().max()) > 0.0
    c1 = float(state.accum[:, 3].sum())
    px, state = render_frame(scene13, env, cam, state, cfg)
    torch.cuda.synchronize()
    check_frame(px, c1, float(state.accum[:, 3].sum()))
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    if march_kernel.LAUNCHES != {"k1a": 0, "k1b": 0, "k1c": n + steps,
                                 "k1d": 0}:
        raise AssertionError(f"frame 13: {march_kernel.LAUNCHES}")
    mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"[3b] frame 13 re-animated on the card: {steps} more K1c "
        f"launches; peak device memory {mem:.2f} GiB")
    calls, _ = capture_frame(scene, env, cam, cfg, state)
    return n + steps, ms, msps, (scene, calls)


def device_profile(fn, frames):
    """One torch.profiler window of ``frames`` calls of fn: the card's busy
    ms per frame (the union of its kernel intervals) and the five kernels
    with the most device time per frame, or None when the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
            cur_e = e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy / 1e3 / frames, [(n[:60], us / 1e3 / frames)
                                 for n, us in top]


def capture_frame(scene, env, cam, cfg, state, per_step=1):
    """One more frame from ``state`` with the march calls' inputs recorded
    (cloned): a wrapper around ``march_kernel.march_resumable_cuda`` for
    this frame alone, ``per_step`` calls a step. Returns ([(origin,
    direction, active, init, cfg)], the state after the frame)."""
    calls, real = [], march_kernel.march_resumable_cuda

    def record(sc, o, d, c, active=None, init=None, **kw):
        calls.append((o.clone(), d.clone(),
                      None if active is None else active.clone(),
                      None if init is None else tuple(v.clone()
                                                      for v in init), c))
        return real(sc, o, d, c, active=active, init=init, **kw)
    march_kernel.march_resumable_cuda = record
    try:
        _, state = render_frame(scene, env, cam, state, cfg)
    finally:
        march_kernel.march_resumable_cuda = real
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    if len(calls) != per_step * steps:
        raise AssertionError(f"recorded {len(calls)} march calls in a frame "
                             f"of {steps} steps")
    return calls, state


def phase_metal_path(dev):
    """The metal bunny at 3840x2160 with bunny_mxu off (K1c) and on (K1d),
    in turns off, on, on, off."""
    cfg = metal_config()
    scene = bunny.metal_scene(dev)
    env = bunny.glass_environment(device=dev)
    cam = bunny.camera(16 / 9, dev)
    out = {False: [], True: []}
    for mxu in (False, True, True, False):
        kind = "k1d" if mxu else "k1c"
        torch.cuda.reset_peak_memory_stats()
        ms, msps, n, state = run_frames(
            scene, env, cam, cfg.replace(bunny_mxu=mxu), kind,
            f"[3c] metal 4K bunny_mxu={mxu}")
        out[mxu].append((ms, msps, n, torch.cuda.max_memory_allocated()
                         / 2**30))
    for mxu in (False, True):
        c = cfg.replace(bunny_mxu=mxu)
        st = [state]

        def frame():
            _, st[0] = render_frame(scene, env, cam, st[0], c)
        frame()
        prof = device_profile(frame, 3)
        ms = statistics.mean(v[0] for v in out[mxu])
        idle = "not measured (the profiler saw no device activity)"
        if prof is not None:
            busy, top = prof
            idle = (f"{busy:.3f} ms/frame busy, idle share "
                    f"{max(0.0, 1 - busy / ms) * 100:.1f}% of {ms:.3f} "
                    f"ms/frame; most device ms/frame: " + "; ".join(
                        f"{n} {v:.3f}" for n, v in top))
        runs = "; ".join(f"{a:.3f} ms/frame, {b:.4f} Msamples/s, peak "
                         f"{m:.2f} GiB" for a, b, _, m in out[mxu])
        log(f"[3c] metal 4K bunny_mxu={mxu}: {runs}; device {idle}")
    mean = lambda mxu, j: statistics.mean(v[j] for v in out[mxu])
    log(f"[3c] metal 4K, mean of two runs each: K1c {mean(False, 0):.3f} "
        f"ms/frame ({mean(False, 1):.4f} Msamples/s), K1d "
        f"{mean(True, 0):.3f} ms/frame ({mean(True, 1):.4f} Msamples/s)")
    calls = {}
    for mxu in (False, True):
        calls[mxu], st[0] = capture_frame(scene, env, cam,
                                          cfg.replace(bunny_mxu=mxu), st[0])
    return out[True][0][2], out, (scene, env, cam, cfg), (scene, calls)


def phase_metal_state_vs_plain(scene, env, cam, cfg):
    """K1c (bit-equal) and K1d (the march bar) against the plain march on
    the metal path's own budget-32 call at 3840x2160, on its state where
    the timed frames start: after the 4 warm-up frames' 16 steps. Returns
    (that state, K1c's and K1d's max abs errors)."""
    mo, md, minit, _ = mixed_state(scene, env, cam, cfg, steps=16)
    cfg = cfg.replace(max_raymarch=cfg.march_split)
    _, err_c = compare(scene, mo, md, cfg, init=minit)
    _, err_d, note = compare_close(
        scene, mo, md, cfg.replace(bunny_mxu=True), init=minit)
    log(f"[3d] metal state at {mo.shape[0]} lanes, 16 steps in: K1c "
        f"bit-equal; K1d within the bar ({note}; max |dt| on the rest "
        f"{err_d:.3e})")
    return (scene, mo, md, minit, cfg), err_c, err_d


def phase_in_frame(glass_calls, metal_calls):
    """The frames' own budget-32 march calls (3b's glass frame, 3c's metal
    frames with K1c and with K1d), each against the plain march, timed,
    and counted. Returns {label: the frame's sums}."""
    glass, gcalls = glass_calls
    metal, mcalls = metal_calls
    return pooled_calls((("glass 1920x1080, K1c", glass, gcalls, False),
                         ("glass 1920x1080, K1d", glass, gcalls, True),
                         ("metal 3840x2160, K1c", metal, mcalls[False],
                          False),
                         ("metal 3840x2160, K1d", metal, mcalls[True],
                          True)))


def pooled_calls(sets, tag="[3e]", names=None):
    """K1c's or K1d's march calls, each against the plain march (K1c
    bit-equal, K1d the march bar), timed, counted, with its bound: for each
    ``(label, scene, calls, bunny_mxu)`` of ``sets``. ``names`` labels the
    calls (default their numbers). Returns {label: the sums}."""
    out = {}
    for label, scene, calls, mxu in sets:
        tot = dict(ms=0.0, bound_ms=0.0, needed=0, slots=0, support=0,
                   mlp=0, warp_mlp=0, err=0.0)
        for j, (o, d, act, init, c) in enumerate(calls):
            cfg = c.replace(bunny_mxu=mxu)
            kind = march_kernel.variant(scene, cfg)
            if mxu:
                k, err, note = compare_close(scene, o, d, cfg, act, init)
            else:
                k, err = compare(scene, o, d, cfg, act, init)
                note = "bit-equal"
            run = lambda: march_kernel.march_resumable_cuda(
                scene, o, d, cfg, active=act, init=init)
            run()
            ms = median_ms(run, 5)
            slots, mlp = speedlight.executed_counts(scene, o, d, cfg, act,
                                                    init)
            support, warp_mlp = speedlight.support_lane_trips(
                scene, o, d, cfg, act, init)
            work = speedlight.mlp_work(support, mlp)
            b = speedlight.march_bound(scene, cfg, k.fin, support, act, init)
            needed = b["lane_iters_needed"]
            log(f"{tag} {label} call {j if names is None else names[j]}: "
                f"{kind.upper()} {note}; {ms:.4f} ms; {o.shape[0]} lanes, "
                f"{int(act.sum()) if act is not None else o.shape[0]} "
                f"active; lane-trips needed {needed}, executed {slots}"
                f" (tax {100 * (1 - needed / max(slots, 1)):.1f}%; warps of "
                f"32 fixed lanes: {speedlight.warp_executed(k.fin)}); MLP "
                f"needed "
                f"{support}, run {mlp} (+{work['mlp_padding_pct']:.1f}%; "
                f"warps of 32 fixed lanes: {warp_mlp}); bound "
                f"{b['bound_ms']:.4f} "
                f"ms ({b['bound_by']}), {100 * b['bound_ms'] / ms:.2f}%")
            for key, v in (("ms", ms), ("bound_ms", b["bound_ms"]),
                           ("needed", needed), ("slots", slots),
                           ("support", support),
                           ("mlp", mlp), ("warp_mlp", warp_mlp)):
                tot[key] += v
            tot["err"] = max(tot["err"], err)
        log(f"{tag} {label}, the {len(calls)} calls: kernel "
            f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({100 * tot['bound_ms'] / tot['ms']:.2f}%); lane-trips needed "
            f"{tot['needed']}, executed {tot['slots']}; MLP needed "
            f"{tot['support']}, run {tot['mlp']}, by warps of 32 lanes "
            f"{tot['warp_mlp']}")
        out[label] = tot
    return out


def phase_in_frame_analytic(frames, tag="[3e]", names=None):
    """The Cornell, tokyo and engine frames' own budget-32 march calls
    (K1a, K1b; recorded in 3 and 3f), each bit-equal to the plain march,
    timed (a call, and back to back: ``device_ms``), with its lane-trips
    needed and executed by warps of 32 fixed lanes and its bound. ``names``
    labels the calls (default their numbers). Returns {label: the sums}."""
    out = {}
    for label, (scene, calls) in frames.items():
        tot = dict(ms=0.0, device_ms=0.0, bound_ms=0.0, needed=0,
                   executed=0, err=0.0)
        for j, (o, d, act, init, c) in enumerate(calls):
            kind = march_kernel.variant(scene, c)
            k, err = compare(scene, o, d, c, act, init)
            run = lambda: march_kernel.march_resumable_cuda(
                scene, o, d, c, active=act, init=init)
            run()
            ms = median_ms(run, 5)
            dev_ms = device_ms(run)
            b = speedlight.march_bound(scene, c, k.fin, 0, act, init)
            needed = b["lane_iters_needed"]
            executed = speedlight.warp_executed(k.fin)
            log(f"{tag} {label} call {j if names is None else names[j]}: "
                f"{kind.upper()} bit-equal; {ms:.4f} "
                f"ms a call, {dev_ms:.4f} ms back to back; {o.shape[0]} "
                f"lanes, {int(act.sum()) if act is not None else o.shape[0]}"
                f" active; lane-trips needed {needed}, executed by warps of "
                f"32 fixed lanes {executed} (tax "
                f"{100 * (1 - needed / max(executed, 1)):.1f}%); bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
                f"{100 * b['bound_ms'] / dev_ms:.2f}% back to back")
            for key, v in (("ms", ms), ("device_ms", dev_ms),
                           ("bound_ms", b["bound_ms"]), ("needed", needed),
                           ("executed", executed)):
                tot[key] += v
            tot["err"] = max(tot["err"], err)
        log(f"{tag} {label}, the {len(calls)} calls: kernel "
            f"{tot['ms']:.4f} ms a call each, {tot['device_ms']:.4f} ms back "
            f"to back; bound {tot['bound_ms']:.4f} ms "
            f"({100 * tot['bound_ms'] / tot['device_ms']:.2f}%); lane-trips "
            f"needed {tot['needed']}, executed {tot['executed']} (tax "
            f"{100 * (1 - tot['needed'] / max(tot['executed'], 1)):.1f}%)")
        out[label] = tot
    return out


def score_golden(img, path, label):
    got = (np.clip(img.cpu().numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
    db = psnr(got, read_png(path)[..., :3])
    if not db >= 35.0:
        raise AssertionError(f"{label} golden PSNR {db:.2f} dB < 35")
    return db


def phase_golden(dev):
    cfg = cornell.full_config().replace(resolution=(64, 64),
                                        max_raymarch=160, max_raytrace=12)
    march_kernel.reset_launches()
    img, state = render_image_progressive(
        cornell.full_scene(dev), cornell.sky(dev), cornell.full_camera(dev),
        cfg, spp=8, exposure=0.6)
    assert march_kernel.LAUNCHES["k1a"] > 0
    db = score_golden(img, GOLDEN, "wavefront_cornell_full")
    log(f"[4] wavefront_cornell_full golden on the card: {db:.2f} dB "
        f"({int(state.frame)} frames)")


def phase_golden_demo(dev):
    """The ``scene_demo`` spec of ``tests/golden_specs.py`` through the
    wavefront integrator: K1b's path (ROLLBACK_TO_ONE + RELATIVE)."""
    cfg = demo.scene_demo_config().replace(resolution=(64, 36),
                                           max_raymarch=128, max_raytrace=8)
    march_kernel.reset_launches()
    img, state = render_image_progressive(
        demo.scene_demo_scene(dev), demo.gradient_environment(dev),
        demo.engine_camera(dev), cfg, spp=6, exposure=1.0)
    launches = dict(march_kernel.LAUNCHES)
    if not (launches["k1b"] > 0 and launches["k1a"] == launches["k1c"]
            == launches["k1d"] == 0):
        raise AssertionError(f"the scene_demo path did not run K1b alone: "
                             f"{launches}")
    db = score_golden(img, GOLDEN_DEMO, "wavefront_scene_demo")
    log(f"[4b] wavefront_scene_demo golden on the card: {db:.2f} dB "
        f"({int(state.frame)} frames, {launches['k1b']} K1b launches)")


# --- the megakernel (render_image) -------------------------------------------


def host_syncs(fn):
    """The host syncs fn() makes, as ``torch.cuda.set_sync_debug_mode``
    reports them (one warning a sync), or None when it reported none."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = sum(1 for w in seen if "synchroniz" in str(w.message).lower())
    return n or None


def megakernel_passes(label, scene, env, cam, cfg, kind, passes, first=1,
                      warm=True, **kw):
    """``bench.py``'s megakernel protocol: ``render_image(spp=1,
    tonemapped=False)`` at sample_offset ``first - 1`` as warm-up (unless
    ``warm`` is False), then ``passes`` timed passes at sample offsets
    ``first``, ``first + 1``, ... ending in a sync. Only ``kind``'s march
    kernel may launch, one launch a bounce (``kind`` may be a tuple: the
    bounce's kernel first, then the shadow rays', each of which must
    launch); the shadow rays' launches are the escape-bound ones, which
    run exactly when ``cfg.env_sampling`` is on. Returns ms/pass,
    Msamples/s, bounces the loop ran a pass, the launches, shadow launches
    a pass, peak GiB and the last image."""
    kinds = (kind,) if isinstance(kind, str) else tuple(kind)
    run = lambda s: render_image(scene, env, cam, cfg, spp=1,
                                 sample_offset=s, tonemapped=False, **kw)
    t0 = time.perf_counter()
    if warm:
        run(first - 1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    for s in range(first, first + passes):
        img = run(s)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / passes
    launches = dict(march_kernel.LAUNCHES)
    bound = dict(march_kernel.BOUND_LAUNCHES)
    if not all(launches[k] for k in kinds) or any(
            v for k, v in launches.items() if k not in kinds):
        raise AssertionError(f"{label}: expected {kinds} launches alone, "
                             f"got {launches}")
    shadow = sum(bound.values())
    if bool(shadow) != cfg.env_sampling:
        raise AssertionError(f"{label}: escape-bound launches {bound} with "
                             f"env_sampling={cfg.env_sampling}")
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0):
        raise AssertionError(f"{label}: the image is not finite and positive")
    # a bounce launches kinds[0] once; the shadow rays' launches are the
    # escape-bound ones
    out = dict(ms=dt * 1e3, msps=cfg.num_pixels / dt / 1e6,
               bounces=(launches[kinds[0]] - bound[kinds[0]]) / passes,
               launches=launches[kinds[0]],
               all_launches={k: launches[k] for k in kinds},
               shadow_per_pass=shadow / passes,
               mem=torch.cuda.max_memory_allocated() / 2**30, img=img)
    log(f"{label}: warm-up pass {warm:.2f} s; {out['ms']:.3f} ms/pass, "
        f"{out['msps']:.4f} Msamples/s over {passes} passes; the loop ran "
        f"{out['bounces']:.2f} bounces a pass; launches "
        f"{out['all_launches']}, escape-bound (shadow) "
        f"{out['shadow_per_pass']:.2f} a pass; peak device memory "
        f"{out['mem']:.2f} GiB")
    if out["ms"] > 60e3:
        log(f"{label}: one pass took {out['ms'] / 1e3:.1f} s (over 60 s)")
    return out


def record_pass(scene, env, cam, cfg, **kw):
    """One megakernel pass (sample 0) with its march calls recorded:
    bounce 0, bounce 1 and the last bounce with a live lane, each
    ``(origin, direction, active, None, cfg)`` cloned, and the pass's
    per-lane bounce counts. Syncs once a bounce (the recording only)."""
    real_march, real_trace = (march_kernel.march_resumable_cuda,
                              integrator.megakernel_trace)
    calls, traces = {}, []

    def record(sc, o, d, c, active=None, init=None, **k):
        b = record.bounce
        record.bounce += 1
        if b < 2 or bool(active.any()):
            calls[min(b, 2)] = (b, (o.clone(), d.clone(), active.clone(),
                                    init, c))
        return real_march(sc, o, d, c, active=active, init=init, **k)
    record.bounce = 0

    def trace(*a, **k):
        out = real_trace(*a, **k)
        traces.append(out)
        return out
    march_kernel.march_resumable_cuda = record
    integrator.megakernel_trace = trace
    try:
        render_image(scene, env, cam, cfg, spp=1, tonemapped=False, **kw)
    finally:
        march_kernel.march_resumable_cuda = real_march
        integrator.megakernel_trace = real_trace
    torch.cuda.synchronize()
    names = [f"bounce {calls[j][0]}" for j in sorted(calls)]
    return [calls[j][1] for j in sorted(calls)], names, traces[0].bounces


def bounce_spread(bounces, label):
    """The bounce by which 99% of a pass's lanes had stopped (a lane's hit
    count is the bounce it stopped at, or one less), and the most."""
    b = torch.sort(bounces.to(torch.int64)).values
    q99, top = int(b[int(0.99 * (b.numel() - 1))]), int(b[-1])
    log(f"{label}: 99% of lanes stopped by bounce {q99 + 1} ({q99} hits or "
        f"fewer); the longest path {top} hits")
    return q99 + 1, top


def pass_profile(label, fn, ms):
    """One torch.profiler pass: device busy, idle share of ``ms``, the top
    kernels."""
    fn()
    prof = device_profile(fn, 1)
    if prof is None:
        log(f"{label}: device busy and idle not measured (the profiler saw "
            f"no device activity)")
        return None
    busy, top = prof
    log(f"{label}: one profiled pass, device busy {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / ms) * 100:.1f}% of {ms:.3f} ms/pass; most "
        f"device ms a pass: " + "; ".join(f"{n} {v:.3f}" for n, v in top))
    return busy, top


def phase_megakernel_cornell(dev):
    """3g: the Cornell full megakernel at 480x480 on bench.py's protocol,
    the loop's exit check at every 8 and 32 bounces and at the default; 3h:
    the minimal Cornell megakernel at 512x512, diffuse_only. Then one
    recorded pass of 3g (3j) and one profiled pass."""
    cfg = cornell.full_config()
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    out = megakernel_passes("[3g] Cornell full megakernel 480x480", scene,
                            env, cam, cfg, "k1a", MEGA_PASSES)
    k_default = integrator.EXIT_CHECK_EVERY
    out["syncs"] = host_syncs(lambda: render_image(
        scene, env, cam, cfg, spp=1, sample_offset=7, tonemapped=False))
    log(f"[3g] host syncs a pass: {out['syncs']} (the exit check every "
        f"{k_default} bounces)")
    for k in (8, 32, k_default):
        integrator.EXIT_CHECK_EVERY = k
        try:
            r = megakernel_passes(f"[3g] exit check every {k} bounces",
                                  scene, env, cam, cfg, "k1a", 3, first=8)
            syncs = host_syncs(lambda: render_image(
                scene, env, cam, cfg, spp=1, sample_offset=8,
                tonemapped=False))
        finally:
            integrator.EXIT_CHECK_EVERY = k_default
        log(f"[3g] exit check every {k}: {r['ms']:.3f} ms/pass, host syncs "
            f"a pass {syncs}")
    out["profile"] = pass_profile(
        "[3g]", lambda: render_image(scene, env, cam, cfg, spp=1,
                                     sample_offset=9, tonemapped=False),
        out["ms"])
    calls, names, bounces = record_pass(scene, env, cam, cfg)
    out["q99"], _ = bounce_spread(bounces, "[3g] Cornell full")

    mcfg = cornell.minimal_config().replace(resolution=(512, 512))
    mscene, mcam = cornell.minimal_scene(dev), cornell.minimal_camera(dev)
    mini = megakernel_passes(
        "[3h] Cornell minimal megakernel 512x512 diffuse_only", mscene, env,
        mcam, mcfg, "k1a", MEGA_PASSES, diffuse_only=True)
    mini["syncs"] = host_syncs(lambda: render_image(
        mscene, env, mcam, mcfg, spp=1, sample_offset=7, tonemapped=False,
        diffuse_only=True))
    log(f"[3h] host syncs a pass: {mini['syncs']}")
    return out, mini, (scene, calls, names)


def phase_megakernel_glass(dev):
    """3i: the glass bunny megakernel at 1920x1080 (glass_config, the scene
    animated to frame 12, the HDR sky), spp 1, with bunny_mxu off (K1c) and
    on (K1d) in turns off, on, on, off; one recorded pass (3j) and one
    profiled pass with K1c."""
    cfg = bunny.glass_config()
    scene = bunny.animated_scene(bunny.glass_scene(dev),
                                 torch.tensor(12.0, device=dev))
    env = bunny.glass_environment(device=dev)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    out = {False: [], True: []}
    for j, mxu in enumerate((False, True, True, False)):
        kind = "k1d" if mxu else "k1c"
        r = megakernel_passes(
            f"[3i] glass bunny megakernel 1920x1080 bunny_mxu={mxu}", scene,
            env, cam, cfg.replace(bunny_mxu=mxu), kind, GLASS_PASSES,
            first=1 + 2 * j, warm=j < 2)
        r.pop("img")
        out[mxu].append(r)
    for mxu in (False, True):
        r = out[mxu][0]
        r["syncs"] = host_syncs(lambda: render_image(
            scene, env, cam, cfg.replace(bunny_mxu=mxu), spp=1,
            sample_offset=20, tonemapped=False))
        log(f"[3i] bunny_mxu={mxu}: host syncs a pass {r['syncs']}; "
            f"{statistics.mean(v['ms'] for v in out[mxu]):.3f} ms/pass, "
            f"{statistics.mean(v['msps'] for v in out[mxu]):.4f} Msamples/s "
            f"(mean of two)")
    prof = pass_profile(
        "[3i] K1c", lambda: render_image(scene, env, cam, cfg, spp=1,
                                         sample_offset=21, tonemapped=False),
        out[False][0]["ms"])
    calls, names, bounces = record_pass(scene, env, cam, cfg)
    q99, top = bounce_spread(bounces, "[3i] glass")
    return out, prof, q99, (scene, calls, names)


def phase_megakernel_calls(cornell_rec, glass_rec):
    """3j: the megakernel's own march calls (bounce 0, bounce 1, the last
    bounce with a live lane) of one pass of 3g (K1a, whole) and of 3i (K1c
    and K1d, the kernel timed on the whole call and held to the plain march
    on every GLASS_SUBSET-th lane, where it is timed and bounded too: 2 M
    lanes x 2048 trips are too many for the plain march; a call with at
    most that many lanes active is held to it whole as well)."""
    scene, calls, names = cornell_rec
    mega_a = phase_in_frame_analytic({"cornell megakernel": (scene, calls)},
                                     tag="[3j]", names=names)
    glass, gcalls, gnames = glass_rec
    sub = [tuple(v[::GLASS_SUBSET].contiguous() for v in (o, d, a)) + (i, c)
           for o, d, a, i, c in gcalls]
    for mxu in (False, True):
        for (o, d, a, i, c), name in zip(gcalls, gnames):
            c = c.replace(bunny_mxu=mxu)
            run = lambda: march_kernel.march_resumable_cuda(
                glass, o, d, c, active=a)
            run()
            note = ""
            if int(a.sum()) <= o.shape[0] // GLASS_SUBSET:
                # few lanes active: the plain march marches them alone
                if mxu:
                    note = "; " + compare_close(glass, o, d, c, a)[2]
                else:
                    compare(glass, o, d, c, a)
                    note = "; bit-equal to the plain march"
            log(f"[3j] glass megakernel {name}, whole call: "
                f"{march_kernel.variant(glass, c).upper()} "
                f"{median_ms(run, 5):.4f} ms at {o.shape[0]} lanes, "
                f"{int(a.sum())} active{note}")
    mega_cd = pooled_calls(
        ((f"{GLASS_CALLS}, K1c", glass, sub, False),
         (f"{GLASS_CALLS}, K1d", glass, sub, True)),
        tag="[3j]", names=gnames)
    return mega_a["cornell megakernel"], mega_cd


def phase_goldens_megakernel(dev):
    """3k: the nine self-goldens through render_image on the card, each
    >= 35 dB against assets/goldens/<name>.png; the march kernel each runs
    (K1b for the ROLLBACK / RELATIVE / CONE configs, K1c for the bunny)."""
    got = {}
    for name in GOLDENS:
        march_kernel.reset_launches()
        img = render_golden(name, dev)
        launches = {k: v for k, v in march_kernel.LAUNCHES.items() if v}
        db = score_golden(img, os.path.join(REPO, "assets", "goldens",
                                            f"{name}.png"), name)
        want = ("k1c" if name.startswith("bunny") else
                "k1b" if name in ("cornell_v3", "scene_demo", "tokyo")
                else "k1a")
        if list(launches) != [want]:
            raise AssertionError(f"{name}: expected {want} alone, got "
                                 f"{launches}")
        got[name] = (db, launches[want])
        log(f"[3k] {name} golden through render_image on the card: "
            f"{db:.2f} dB, {launches[want]} {want.upper()} launches")
    return got


def phase_offline_app():
    """3l: the offline renderer as a user runs it, in a subprocess."""
    out = os.path.join(REPO, "build", "offline_smoke")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "raytracingpbr_tpu_torch.apps.offline",
           "--scene", "cornell", "--frames", "1", "--spp", "1", "--scale",
           "1", "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"offline app: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    img = read_png(os.path.join(out, "frame_00000.png"))
    if img.shape != (480, 480, 3) or not img.mean() > 0:
        raise AssertionError(f"offline app: PNG {img.shape}, mean "
                             f"{img.mean()}")
    log(f"[3l] {' '.join(cmd[1:])}: rc 0 in {secs:.1f} s, a 480x480 PNG of "
        f"mean {img.mean():.2f}; {proc.stdout.strip().splitlines()[-1]}")
    return secs


def report(label, u):
    log(f"[5] {label}: {u['march_ms']:.4f} ms; lane-trips needed "
        f"{u['lane_iters_needed']}, executed {u['lane_iters_executed']}"
        f" (divergence tax {u['divergence_tax_pct']:.1f}%); MLP needed "
        f"(inside the bunny's sphere) {u['support_lane_iters']}, run "
        f"{u['mlp_lane_iters_executed']} (+{u['mlp_padding_pct']:.1f}%; "
        f"by warps of 32 fixed lanes: {u['mlp_warp_lane_iters']}); "
        f"{u['flops_per_iter']} flops/iter; "
        f"{u['flops']:.4e} flops ({u['tensor_core_flops']:.4e} on tensor "
        f"cores), {u['bytes']} bytes; {u['achieved_gflops']:.1f} GFLOP/s = "
        f"{u['utilization_pct']:.2f}% of K2's roof, {u['fp32_peak_pct']:.2f}%"
        f" of 67 TFLOP/s; bound {u['bound_ms']:.4f} ms ({u['bound_by']}), "
        f"{u['bound_share_pct']:.2f}% of the time")


def phase_utilization(dev, states):
    """bench.py's utilization extra, then each kernel's budget-32 state.
    The one K2 sweep here is the one
    ``march_utilization`` reads its roof from (``speedlight.fma_sweep``
    measures once a process)."""
    march_kernel.reset_launches()
    fma_kernel.reset_launches()
    speedlight.fma_sweep.cache_clear()
    sweep = speedlight.fma_sweep()
    for c, f in sweep.items():
        log(f"[5] K2 (threads, iters, chains, unroll) = {c}: "
            f"{f / 1e9:.1f} GFLOP/s")
    roof = speedlight.measure_vpu_peak()
    log(f"[5] K2 FP32 FFMA roof {roof / 1e9:.1f} GFLOP/s = "
        f"{roof / speedlight.H100_FP32_FLOPS * 100:.2f}% of the published "
        f"67 TFLOP/s, on {card_line()}")
    cfg = cornell.full_config()
    o, d = primaries(cfg, cornell.full_camera(dev))
    report("bench.py's Cornell march, 480x480 primaries, 512 trips, K1a",
           speedlight.march_utilization(cornell.full_scene(dev), o, d, cfg))
    bounds = {}
    for name, label in (("k1a", "Cornell mixed state"),
                        ("k1b", "scene_demo 768x432 primaries"),
                        ("k1c", "glass mixed state 1920x1080"),
                        ("k1d", "glass mixed state 1920x1080"),
                        ("k1c metal", "metal state 3840x2160, 16 steps"),
                        ("k1d metal", "metal state 3840x2160, 16 steps")):
        scene, so, sd, sinit, scfg = states[name]
        u = speedlight.march_utilization(scene, so, sd, scfg, init=sinit)
        report(f"{name.split()[0].upper()} budget-32, {label}", u)
        bounds[name] = u
    launches = {**march_kernel.LAUNCHES, **fma_kernel.LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the utilization path did not "
                             f"launch: {launches}")
    log(f"[5] launches in the utilization path: {launches}")
    return launches["k2"], roof, bounds


# --- environment sampling (NEE / MIS) and the progressive daemon -------------

def sun_sky(dev):
    """``bench.py:119-127``'s sun sky for the NEE Cornell megakernel: 64x32
    texels of 0.05 with a 4x4 sun of 25."""
    img = np.full((64, 32, 3), 0.05, np.float32)
    img[40:44, 24:28] = 25.0
    return ibl.hdr_environment(img, prebake=False, device=dev)


def phase_alias_tables(dev):
    """7a: the alias tables of the engine, tokyo and glass skies and of
    the bench's sun sky, with their sizes and build times (Vose on the
    host, then copied to the card)."""
    out = {}
    for label, env in (("engine", demo.engine_environment(device=dev)),
                       ("tokyo", demo.tokyo_environment(device=dev)),
                       ("glass", bunny.glass_environment(device=dev)),
                       ("sun", sun_sky(dev))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        baked = ibl.with_env_sampler(env)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        w, h = env.image.shape[:2]
        n = w * h
        if not (baked.s_prob.device == env.image.device
                and bool((baked.s_prob >= 0).all())
                and bool((baked.s_prob <= 1).all())
                and int(baked.s_alias.min()) >= 0
                and int(baked.s_alias.max()) < n
                and bool(torch.isfinite(baked.s_pdf).all())):
            raise AssertionError(f"{label}: the alias table is malformed")
        nbytes = sum(t.numel() * t.element_size()
                     for t in (baked.s_prob, baked.s_alias, baked.s_pdf))
        log(f"[7a] {label} sky {w}x{h}: {n} texels, alias table "
            f"(prob, alias, pdf) {nbytes} bytes on the card, built in "
            f"{ms:.2f} ms")
        out[label] = baked
    return out


def is_shadow(c, cfg) -> bool:
    """A recorded march call is a shadow march: the escape bound is on
    where the path's own configuration has it off (no model config sets
    it)."""
    return c.escape_bound and not cfg.escape_bound


def phase_nee_wavefront(dev, tables):
    """7b: the engine (768x432) and tokyo (2880x1620) frames with
    ``env_sampling`` off and on, in turns off, on, on, off, on PERF.md
    section 2's protocol; with NEE K1b launches twice a step (the bounce
    and the shadow rays). One profiled NEE frame each, then one more NEE
    frame whose march calls are recorded (the shadow calls go to 7d).
    Returns ({label: {nee: [(ms, Msamples/s, launches, GiB, escape-bound
    launches a frame)]}}, {label: (scene, shadow calls)}, {label:
    profile})."""
    out, shadows, profiles = {}, {}, {}
    for label, (scene, env, cam, cfg) in k1b_paths(dev).items():
        nee_env = tables[label.split()[0]]
        ncfg = cfg.replace(env_sampling=True)
        runs = {False: [], True: []}
        for nee in (False, True, True, False):
            torch.cuda.reset_peak_memory_stats()
            ms, msps, n, state = run_frames(
                scene, nee_env if nee else env, cam, ncfg if nee else cfg,
                "k1b", f"[7b] {label} env_sampling={nee}",
                per_step=2 if nee else 1)
            runs[nee].append((ms, msps, n,
                              torch.cuda.max_memory_allocated() / 2**30,
                              march_kernel.BOUND_LAUNCHES["k1b"]
                              / (4 + TIMED_FRAMES)))
            if nee:
                nee_state = state
        st = [nee_state]

        def frame():
            _, st[0] = render_frame(scene, nee_env, cam, st[0], ncfg)
        mean = lambda nee, j: statistics.mean(v[j] for v in runs[nee])
        prof = device_profile(frame, 2)
        desc = "device busy and idle not measured (no device activity seen)"
        if prof is not None:
            busy, top = prof
            desc = (f"one profiled NEE frame: device busy {busy:.3f} ms, idle "
                    f"share {max(0.0, 1 - busy / mean(True, 0)) * 100:.1f}% "
                    f"of {mean(True, 0):.3f} ms/frame; most device ms/frame: "
                    + "; ".join(f"{k} {v:.3f}" for k, v in top))
        profiles[label] = prof
        log(f"[7b] {label}: NEE off {mean(False, 0):.3f} ms/frame, "
            f"{mean(False, 1):.4f} Msamples/s; NEE on {mean(True, 0):.3f} "
            f"ms/frame, {mean(True, 1):.4f} Msamples/s (means of two; "
            f"{mean(True, 0) / mean(False, 0):.3f}x the frame time); peak "
            f"{mean(True, 3):.2f} GiB with NEE; {desc}")
        calls, _ = capture_frame(scene, nee_env, cam, ncfg, st[0],
                                 per_step=2)
        shadow = [c for c in calls if is_shadow(c[4], ncfg)]
        if len(shadow) != runs[True][0][4]:
            raise AssertionError(f"{label}: {len(shadow)} shadow calls "
                                 f"recorded, {runs[True][0][4]} launched a "
                                 f"frame in the timed runs")
        out[label] = runs
        shadows[f"{label} NEE shadow"] = (scene, shadow)
    return out, shadows, profiles


def record_shadow_pass(scene, env, cam, cfg, **kw):
    """One megakernel pass (sample 0) with its shadow-march calls recorded:
    bounce 0, bounce 1 and the last with a live lane, each cloned. Returns
    (calls, names)."""
    real = march_kernel.march_resumable_cuda
    calls = {}

    def record(sc, o, d, c, active=None, init=None, **k):
        if is_shadow(c, cfg):
            b = record.bounce
            record.bounce += 1
            if b < 2 or bool(active.any()):
                calls[min(b, 2)] = (b, (o.clone(), d.clone(), active.clone(),
                                        init, c))
        return real(sc, o, d, c, active=active, init=init, **k)
    record.bounce = 0
    march_kernel.march_resumable_cuda = record
    try:
        render_image(scene, env, cam, cfg, spp=1, tonemapped=False, **kw)
    finally:
        march_kernel.march_resumable_cuda = real
    torch.cuda.synchronize()
    names = [f"bounce {calls[j][0]}" for j in sorted(calls)]
    return [calls[j][1] for j in sorted(calls)], names


def phase_nee_megakernel(dev, tables):
    """7c: the megakernel with NEE on ``bench.py:88-108``'s pass protocol:
    the Cornell full box at 480x480 (``max_raytrace`` 128) under the
    bench's sun sky, K1a for the bounces and K1b for the shadow rays (the
    forward half of ``bench.py``'s replay+NEE extra); the glass bunny at
    1920x1080 under its HDR sky with K1c and K1d in turns off, on, on,
    off. Host syncs a pass; then one K1c glass pass whose shadow calls are
    recorded (7d). Returns (Cornell, {mxu: [runs]}, the glass record)."""
    cfg = cornell.full_config().replace(max_raytrace=128, env_sampling=True)
    scene, cam = cornell.full_scene(dev), cornell.full_camera(dev)
    env = tables["sun"]
    corn = megakernel_passes("[7c] Cornell full NEE megakernel 480x480, "
                             "sun sky", scene, env, cam, cfg,
                             ("k1a", "k1b"), MEGA_PASSES)
    corn["syncs"] = host_syncs(lambda: render_image(
        scene, env, cam, cfg, spp=1, sample_offset=7, tonemapped=False))
    log(f"[7c] Cornell NEE: host syncs a pass {corn['syncs']}")
    corn.pop("img")

    gcfg = bunny.glass_config().replace(env_sampling=True)
    glass = bunny.animated_scene(bunny.glass_scene(dev),
                                 torch.tensor(12.0, device=dev))
    genv = tables["glass"]
    gcam = bunny.camera(gcfg.width / gcfg.height, dev)
    runs = {False: [], True: []}
    for j, mxu in enumerate((False, True, True, False)):
        kind = "k1d" if mxu else "k1c"
        r = megakernel_passes(
            f"[7c] glass NEE megakernel 1920x1080 bunny_mxu={mxu}", glass,
            genv, gcam, gcfg.replace(bunny_mxu=mxu), kind, GLASS_PASSES,
            first=1 + 2 * j, warm=j < 2)
        r.pop("img")
        runs[mxu].append(r)
    for mxu in (False, True):
        runs[mxu][0]["syncs"] = host_syncs(lambda: render_image(
            glass, genv, gcam, gcfg.replace(bunny_mxu=mxu), spp=1,
            sample_offset=20, tonemapped=False))
        log(f"[7c] glass NEE bunny_mxu={mxu}: "
            f"{statistics.mean(v['ms'] for v in runs[mxu]):.3f} ms/pass, "
            f"{statistics.mean(v['msps'] for v in runs[mxu]):.4f} Msamples/s"
            f" (mean of two), host syncs a pass {runs[mxu][0]['syncs']}")
    calls, names = record_shadow_pass(glass, genv, gcam, gcfg)
    return corn, runs, (glass, calls, names)


def phase_shadow_calls(frames, glass_rec, per_frame, per_pass):
    """7d: the shadow-march calls of one NEE frame of engine and tokyo
    (K1b, bit-equal, a call and back to back) and of one glass NEE pass
    (K1c bit-equal, K1d within the march bar), each timed, with lane-trips
    needed and executed, bound and share. ``per_frame`` and ``per_pass``:
    the escape-bound launches that 7b's timed frames and 7c's timed passes
    made. Returns (analytic sums, pooled sums)."""
    ab = phase_in_frame_analytic(frames, tag="[7d]")
    glass, calls, names = glass_rec
    cd = pooled_calls(((f"glass NEE shadow, K1c", glass, calls, False),
                       (f"glass NEE shadow, K1d", glass, calls, True)),
                      tag="[7d]", names=names)
    log("[7d] shadow (escape-bound) launches in the timed runs: "
        + ", ".join(f"{k} {v:g} a frame" for k, v in per_frame.items())
        + "".join(f"; glass NEE bunny_mxu={k} {v:g} a pass"
                    for k, v in per_pass.items()))
    return ab, cd


def nee_test_scenes(dev):
    """``tests/test_nee.py:27-55, 175-197``'s sun-lit and glossy scenes and
    skies and its ``base_cfg`` at NEE_STATS_RES."""
    img = np.full((32, 16, 3), 0.05, np.float32)
    img[8:12, 11:15] = 25.0
    front = np.full((32, 16, 3), 0.05, np.float32)
    front[24:28, 11:15] = 25.0
    sky = lambda a: ibl.hdr_environment(a, prebake=False, device=dev)
    sun = scenelib.make_scene([
        scenelib.ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0),
                            scale=(100,) * 3, albedo=(0.7, 0.7, 0.7),
                            roughness=1.0),
        scenelib.ObjectSpec(SHAPE.SPHERE, position=(0, 0, 0),
                            scale=(1.0,) * 3, albedo=(0.6, 0.4, 0.3),
                            roughness=1.0)], device=dev)
    glossy = scenelib.make_scene([
        scenelib.ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0),
                            scale=(100,) * 3, albedo=(0.7, 0.7, 0.7),
                            roughness=0.8, metallic=1.0),
        scenelib.ObjectSpec(SHAPE.SPHERE, position=(0, 0, 0),
                            scale=(1.0,) * 3, albedo=(0.9, 0.9, 0.9),
                            roughness=0.5, metallic=1.0)], device=dev)
    cam = make_camera(lookfrom=(0, 1.0, 4.0), lookat=(0, 0, 0), vfov=40.0,
                      aspect=1.0, aperture=0.0, focus=1.0, device=dev)
    cfg = RenderConfig(resolution=NEE_STATS_RES, max_raymarch=48,
                       max_raytrace=4, light_quality=1e9,
                       roulette=Roulette.EXP, omega=1.0,
                       omega_policy=OmegaPolicy.CONSTANT,
                       hit_criterion=HitCriterion.ABSOLUTE,
                       hit_precision=1e-4, march_t0=0.005, max_dis=300.0)
    return (sun, sky(img)), (glossy, sky(front)), cam, cfg


def phase_nee_statistics(dev):
    """7e: ``tests/test_nee.py``'s statistical bars on the card at
    NEE_STATS_RES over NEE_SEEDS seeds of NEE_SPP samples: the sun-lit and
    the glossy scene, means within rel 0.25 and the NEE variance below half
    the plain one (``:110-113``, ``:217-220``); specular MIS below 0.6x
    the variance of diffuse-only NEE on the glossy scene (``:240``)."""
    (sun, sun_env), (glossy, front_env), cam, cfg = nee_test_scenes(dev)

    def seeds(scene, env, c):
        return torch.stack([render_image(scene, env, cam, c.replace(seed=s),
                                         spp=NEE_SPP, tonemapped=False)
                            for s in range(NEE_SEEDS)])
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    out = {}
    for label, scene, env, c in (("sun-lit", sun, sun_env, cfg),
                                 ("glossy", glossy, front_env,
                                  cfg.replace(max_raytrace=6))):
        off = seeds(scene, env, c)
        env_s = ibl.with_env_sampler(env)
        on = seeds(scene, env_s, c.replace(env_sampling=True))
        m_off, m_on = float(off.mean()), float(on.mean())
        v_off = float(off.var(dim=0, unbiased=False).mean())
        v_on = float(on.var(dim=0, unbiased=False).mean())
        ok = abs(m_on - m_off) <= 0.25 * abs(m_off) and v_on < 0.5 * v_off
        log(f"[7e] {label}: mean NEE {m_on:.6f} vs plain {m_off:.6f} (rel "
            f"{abs(m_on / m_off - 1):.4f}, bar 0.25); variance ratio "
            f"{v_on / v_off:.4f} (bar < 0.5)")
        if not ok:
            raise AssertionError(f"[7e] {label}: NEE statistics off the bar")
        out[label] = (m_on / m_off, v_on / v_off)
        if label == "glossy":
            no = seeds(scene, env_s, c.replace(env_sampling=True,
                                               mis_specular=False))
            v_no = float(no.var(dim=0, unbiased=False).mean())
            log(f"[7e] glossy: MIS variance {v_on:.6e} vs diffuse-only NEE "
                f"{v_no:.6e}, ratio {v_on / v_no:.4f} (bar < 0.6)")
            if not v_on < 0.6 * v_no:
                raise AssertionError("[7e] specular MIS does not beat "
                                     "diffuse-only NEE")
            out["mis"] = v_on / v_no
    launches = dict(march_kernel.LAUNCHES)
    if not (launches["k1a"] and launches["k1b"]):
        raise AssertionError(f"[7e] expected K1a and K1b, got {launches}")
    log(f"[7e] {NEE_STATS_RES[0]}x{NEE_STATS_RES[1]}, {NEE_SEEDS} seeds x "
        f"{NEE_SPP} spp each, in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    return out


def phase_progressive(dev):
    """7f: the progressive daemon as a user runs it, ``--scene demo --nee``
    (the engine scene at 768x432 under its HDR sky), twice in a subprocess:
    the second run resumes from the first's checkpoint. The final
    checkpoint must equal, bit for bit, a straight render of as many frames
    in this process; and here 6 frames straight must equal 3 frames, a
    checkpoint, a load and 3 more (``accum`` and ``pixels``)."""
    out = os.path.join(REPO, "build", "progressive_smoke")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "raytracingpbr_tpu_torch.apps.progressive",
           "--scene", "demo", "--nee", "--minutes", str(PROGRESSIVE_MINUTES),
           "--out", out, "--metrics", os.path.join(out, "metrics.jsonl")]
    t0 = time.perf_counter()
    frames = []
    for run in range(2):
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"progressive app: rc {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        st, meta = ckpt.load(os.path.join(out, "state.npz"), device=dev)
        if run and f"resumed from frame {frames[0]}" not in proc.stdout:
            raise AssertionError(f"the second run did not resume: "
                                 f"{proc.stdout[-500:]}")
        frames.append(int(st.frame))
    secs = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    scene, env, cam, cfg, exposure = progressive.scene_setup(
        "demo", nee=True, device=dev)
    march_kernel.reset_launches()

    def straight(state, n):
        px = None
        for _ in range(n):
            px, state = render_frame(scene, env, cam, state, cfg,
                                     exposure=exposure)
        return px, state
    fresh = lambda: make_frame_state(cfg.num_pixels, device=dev)
    px, ref = straight(fresh(), frames[1])
    for k in ("accum", "pixels", "sky_w", "respawn", "march_state",
              "march_cum", "noise", "diff_accum", "hit_t"):
        if not torch.equal(getattr(ref, k), getattr(st, k)):
            raise AssertionError(f"the app's two runs and a straight render "
                                 f"of {frames[1]} frames differ in {k}")
    if not torch.equal(ref.rays.color, st.rays.color):
        raise AssertionError("the app's rays differ from a straight render")
    launches = dict(march_kernel.LAUNCHES)
    if launches != {"k1a": 0, "k1b": 2 * frames[1], "k1c": 0, "k1d": 0}:
        raise AssertionError(f"[7f] launches {launches}")
    px6, six = straight(fresh(), 6)
    _, three = straight(fresh(), 3)
    path = os.path.join(out, "mid.npz")
    ckpt.save(path, three)
    back, _ = ckpt.load(path, device=dev)
    px_b, back = straight(back, 3)
    if not (torch.equal(six.accum, back.accum)
            and torch.equal(six.pixels, back.pixels)
            and torch.equal(px6, px_b)):
        raise AssertionError("resume after 3 of 6 frames is not bit-exact")
    log(f"[7f] progressive --scene demo --nee --minutes "
        f"{PROGRESSIVE_MINUTES}, twice: rc 0, frames {frames[0]} then "
        f"{frames[1]} (resumed), {secs:.1f} s of subprocess; last frame "
        f"{rec[-1]['dt'] * 1e3:.1f} ms, {rec[-1]['mean_spp']:.2f} spp mean; "
        f"the checkpoint equals a straight render of {frames[1]} frames bit "
        f"for bit ({launches['k1b']} K1b launches); 6 frames straight equal "
        f"3 + checkpoint + 3 in accum and pixels")
    return frames, rec[-1]


def nee_phases(dev):
    """7a-7f. Returns what the summary and the kernels line read."""
    tables = phase_alias_tables(dev)
    wave, shadows, _ = phase_nee_wavefront(dev, tables)
    corn, glass, glass_rec = phase_nee_megakernel(dev, tables)
    per_frame = {f"{k} NEE shadow": statistics.mean(r[4] for r in v[True])
                 for k, v in wave.items()}
    per_pass = {mxu: statistics.mean(r["shadow_per_pass"] for r in v)
                for mxu, v in glass.items()}
    ab, cd = phase_shadow_calls(shadows, glass_rec, per_frame, per_pass)
    del shadows, glass_rec
    stats = phase_nee_statistics(dev)
    frames, last = phase_progressive(dev)
    mean = lambda runs, j: statistics.mean(v[j] for v in runs)
    gms = lambda mxu: statistics.mean(v["ms"] for v in glass[mxu])
    log("[7] summary: " + "; ".join(
        f"{k} NEE off {mean(v[False], 0):.3f} / on {mean(v[True], 0):.3f} "
        f"ms/frame ({mean(v[False], 1):.4f} / {mean(v[True], 1):.4f} "
        f"Msamples/s), shadow calls {ab[k + ' NEE shadow']['device_ms']:.4f}"
        f" ms a frame back to back, bound "
        f"{ab[k + ' NEE shadow']['bound_ms']:.4f}" for k, v in wave.items())
        + f"; Cornell NEE megakernel {corn['ms']:.3f} ms/pass "
        f"({corn['msps']:.4f} Msamples/s, {corn['bounces']:.1f} bounces, "
        f"{corn['syncs']} host syncs); glass NEE K1c {gms(False):.3f} / K1d "
        f"{gms(True):.3f} ms/pass ({glass[False][0]['bounces']:.1f} "
        f"bounces); glass shadow calls K1c "
        f"{cd['glass NEE shadow, K1c']['ms']:.4f} / K1d "
        f"{cd['glass NEE shadow, K1d']['ms']:.4f} ms, "
        f"{per_pass[False]:g} / {per_pass[True]:g} shadow launches a pass; "
        f"statistics {stats}; progressive {frames[1]} frames")
    return dict(ab=ab, cd=cd, per_frame=per_frame, per_pass=per_pass,
                corn=corn, glass=glass)


# --- gradients: scan-AD, path replay and the train step ---------------------


def grad_config(max_raytrace, env_sampling=False, **kw):
    """``bench.py:110-152``'s fwd+bwd configuration: Cornell full at
    480x480 with ``max_raytrace`` bounces (and NEE under the sun sky)."""
    return cornell.full_config().replace(max_raytrace=max_raytrace,
                                         env_sampling=env_sampling, **kw)


def albedo_grad(scene, env, cam, cfg, mode, s, target=None):
    """One fwd+bwd step of ``bench.py``'s protocol: ``render_pixels`` at
    spp 1, sample offset ``s``, the MSE against ``target`` (zeros), the
    gradient of ``albedo`` (``mode``: True scan-AD, ``"replay"``)."""
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                       device=scene.device)
    albedo = scene.albedo.clone().requires_grad_(True)
    img = ptrain.render_pixels(scene.replace(albedo=albedo), env, cam, pid,
                               cfg, spp=1, sample_offset=s,
                               differentiable=mode)
    target = torch.zeros_like(img) if target is None else target
    (g,) = torch.autograd.grad(torch.mean((img - target) ** 2), albedo)
    return g


def fwd_bwd(label, scene, env, cam, cfg, mode, kinds, steps=GRAD_STEPS):
    """``bench.py``'s fwd+bwd protocol: one warm-up step (sample 0), then
    ``steps`` timed steps (samples 1..steps) ending in a sync. The launch
    counts are set to 0 before the timed steps and read after: only
    ``kinds`` may launch, each at least once. Returns s/step, Msamples/s
    (pixels / s/step), the steps' peak GiB (above what was allocated
    before them), launches a step and the last gradient."""
    t0 = time.perf_counter()
    albedo_grad(scene, env, cam, cfg, mode, 0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    for s in range(1, steps + 1):
        g = albedo_grad(scene, env, cam, cfg, mode, s)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(march_kernel.LAUNCHES)
    shadow = sum(march_kernel.BOUND_LAUNCHES.values())
    if not all(launches[k] for k in kinds) or any(
            v for k, v in launches.items() if k not in kinds):
        raise AssertionError(f"{label}: expected {kinds} launches alone, "
                             f"got {launches}")
    if bool(shadow) != cfg.env_sampling:
        raise AssertionError(f"{label}: escape-bound launches {shadow} with "
                             f"env_sampling={cfg.env_sampling}")
    if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
        raise AssertionError(f"{label}: the albedo gradient is not finite "
                             f"and nonzero: {g.tolist()}")
    out = dict(s=dt, msps=cfg.num_pixels / dt / 1e6,
               mem=(torch.cuda.max_memory_allocated() - held) / 2**30,
               launches={k: launches[k] / steps for k in kinds},
               shadow=shadow / steps, grad=g)
    log(f"[{label}] warm-up step {warm:.2f} s; {dt:.4f} s/step, "
        f"{out['msps']:.4f} Msamples/s over {steps} steps; peak device "
        f"memory {out['mem']:.3f} GiB above the {held / 2**30:.3f} held "
        f"before; launches a step "
        f"{out['launches']}, escape-bound (shadow) {out['shadow']:g}; "
        f"card {card_line()}")
    return out


def step_anatomy(label, scene, env, cam, cfg, mode, out):
    """One profiled fwd+bwd step (device busy, idle share of the timed
    s/step, the top kernels) and the host syncs of one step, into
    ``out``."""
    fn = lambda: albedo_grad(scene, env, cam, cfg, mode, 7)
    out["profile"] = pass_profile(f"[{label}]", fn, out["s"] * 1e3)
    out["syncs"] = host_syncs(fn)
    log(f"[{label}] host syncs a step: {out['syncs']}")


def record_step(fn):
    """Runs ``fn()`` with every march kernel call's inputs recorded
    (cloned): ``[(origin, direction, active, init, cfg)]``."""
    real = march_kernel.march_resumable_cuda
    calls = []

    def record(sc, o, d, c, active=None, init=None, **k):
        calls.append((sc, (o.clone(), d.clone(),
                           None if active is None else active.clone(),
                           init, c)))
        return real(sc, o, d, c, active=active, init=init, **k)
    march_kernel.march_resumable_cuda = record
    try:
        fn()
    finally:
        march_kernel.march_resumable_cuda = real
    torch.cuda.synchronize()
    return calls


def hold_calls(label, calls):
    """Each recorded call bit-equal to the plain march (kernel and plain
    both run anew on the recorded inputs). Returns {kind: (calls, max abs
    err)}."""
    out = {}
    for sc, (o, d, a, i, c) in calls:
        kind = march_kernel.variant(sc, c)
        _, err = compare(sc, o, d, c, a, i)
        n, e = out.get(kind, (0, 0.0))
        out[kind] = (n + 1, max(e, err))
    log(f"[{label}] every march call of one step bit-equal to the plain "
        f"march: " + ", ".join(f"{k.upper()} {n} calls" for k, (n, _)
                               in sorted(out.items())))
    return out


def peak_step(scene, env, cam, cfg, mode):
    """Peak device memory (GiB) of one fwd+bwd step, above what was
    allocated before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    albedo_grad(scene, env, cam, cfg, mode, 9)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**30


def phase_scan_ad(dev):
    """8a: scan-AD on ``bench.py:110-152``'s protocol (Cornell full
    480x480, 8 bounces, spp 1, MSE against zeros, the albedo gradient):
    K1a a bounce; one profiled step and its host syncs. Then every K1a
    call of one step held bit-equal to the plain march."""
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    cfg = grad_config(8)
    out = fwd_bwd("8a scan-AD, 8 bounces", scene, env, cam, cfg, True,
                  ("k1a",))
    step_anatomy("8a", scene, env, cam, cfg, True, out)
    calls = record_step(lambda: albedo_grad(scene, env, cam, cfg, True, 5))
    out["held"] = hold_calls("8a", calls)
    return out


def phase_replay(dev):
    """8b: path replay at 128 bounces (``bench.py:196-207``) with the march
    checkpoint (the default here) and without it, the same protocol; the
    two gradients within ``tests/test_replay.py:222``'s bar (rtol 1e-5,
    atol 1e-7 max); peak memory at 4, 16, 32 and 128 bounces both ways,
    and scan-AD's at 4 and 16 (the O(rays) claim: without the checkpoint
    the peak does not grow from 4 bounces to 16, while scan-AD's does).
    The K1a calls of one step without the checkpoint (the
    forward's and the re-march's) held bit-equal to the plain march."""
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    out = {}
    for ckpt in (True, False):
        cfg = grad_config(128, replay_march_checkpoint=ckpt)
        out[ckpt] = fwd_bwd(f"8b replay, 128 bounces, checkpoint {ckpt}",
                            scene, env, cam, cfg, "replay", ("k1a",))
    step_anatomy("8b", scene, env, cam, grad_config(128), "replay",
                 out[True])
    a, b = out[True]["grad"], out[False]["grad"]
    torch.testing.assert_close(b, a, rtol=1e-5,
                               atol=1e-7 * float(a.abs().max()))
    log(f"[8b] checkpoint on and off: albedo gradients within rtol 1e-5 "
        f"(max |diff| {float((a - b).abs().max()):.3e} of "
        f"{float(a.abs().max()):.3e})")
    # the loop runs about 19 bounces at 128, so 32 and 128 run the same
    # bounces and cannot show growth: the O(rays) check is 4 against 16,
    # which it reaches, with scan-AD's peak (a graph a bounce) beside it
    modes = {"scan-AD": (True, None, (4, 16)),
             "replay, checkpoint on": ("replay", True, (4, 16, 32, 128)),
             "replay, checkpoint off": ("replay", False, (4, 16, 32, 128))}
    peaks = {}
    for label, (mode, ckpt, budgets) in modes.items():
        for bounces in budgets:
            cfg = (grad_config(bounces) if ckpt is None else
                   grad_config(bounces, replay_march_checkpoint=ckpt))
            peaks[(label, bounces)] = peak_step(scene, env, cam, cfg, mode)
    log("[8b] peak device memory of a step: " + "; ".join(
        f"{k[0]}, {k[1]} bounces {v:.3f} GiB" for k, v in peaks.items()))
    grow = {label: peaks[(label, 16)] / peaks[(label, 4)] for label in modes}
    log("[8b] peak at 16 bounces over 4: " + ", ".join(
        f"{k} {v:.4f}x" for k, v in grow.items()))
    if not (grow["replay, checkpoint off"] < 1.05 and grow["scan-AD"] > 1.5):
        raise AssertionError(f"8b: replay's peak without the checkpoint "
                             f"grew with the bounces, or scan-AD's did not "
                             f"(16 over 4 bounces: {grow})")
    out["peaks"] = peaks
    cfg = grad_config(128, replay_march_checkpoint=False)
    calls = record_step(lambda: albedo_grad(scene, env, cam, cfg, "replay",
                                            5))
    out["held"] = hold_calls("8b", calls)
    return out


def phase_replay_nee(dev):
    """8c: replay + NEE at 128 bounces (``bench.py:208-215``) under the
    64x32 sun sky, the same protocol: K1a the bounces, K1b the shadow
    rays. The K1a and K1b calls of one step held bit-equal to the plain
    march."""
    scene, cam = cornell.full_scene(dev), cornell.full_camera(dev)
    env = ibl.with_env_sampler(sun_sky(dev))
    cfg = grad_config(128, env_sampling=True)
    out = fwd_bwd("8c replay + NEE, 128 bounces", scene, env, cam, cfg,
                  "replay", ("k1a", "k1b"))
    step_anatomy("8c", scene, env, cam, cfg, "replay", out)
    calls = record_step(lambda: albedo_grad(scene, env, cam, cfg, "replay",
                                            5))
    out["held"] = hold_calls("8c", calls)
    if "k1b" not in out["held"]:
        raise AssertionError("8c: no shadow call was recorded")
    return out


def phase_replay_vs_scan(dev):
    """8d: replay equals scan-AD on the card: Cornell full 480x480, 12
    bounces, the albedo and emission gradients of the mean image at
    ``tests/test_replay.py:66``'s bar (rtol 2e-4, atol 2e-6 max)."""
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    cfg = grad_config(12)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    grads = {}
    for mode in (True, "replay"):
        leaves = {k: getattr(scene, k).clone().requires_grad_(True)
                  for k in ("albedo", "emission")}
        img = ptrain.render_pixels(scene.replace(**leaves), env, cam, pid,
                                   cfg, spp=1, differentiable=mode)
        grads[mode] = torch.autograd.grad(img.mean(), list(leaves.values()))
    worst = 0.0
    for name, a, b in zip(("albedo", "emission"), grads[True],
                          grads["replay"]):
        if not float(a.abs().max()) > 0:
            raise AssertionError(f"8d: scan-AD's {name} gradient is 0")
        torch.testing.assert_close(b, a, rtol=2e-4,
                                   atol=2e-6 * float(a.abs().max()))
        worst = max(worst, float(((a - b).abs() / a.abs().clamp_min(
            1e-30)).max()))
    log(f"[8d] replay vs scan-AD, {cfg.width}x{cfg.height} x 12 bounces: "
        f"albedo and emission within rtol 2e-4 (largest relative difference "
        f"{worst:.3e})")
    return worst


def phase_train(dev):
    """8e: the train step on the card. ``tests/test_parallel.py:236-282``'s
    albedo recovery on one card (16x16, 30 steps of Adam under the cosine
    schedule from 0.08, albedo only): the last three losses average under
    0.2x the first, the albedo within 0.1 of the truth. Then 1 + 5 timed
    steps at full width (Cornell full 480x480, 8 bounces, materials only,
    dual buffer, Adam at 0.01 toward a render of the true scene), and one
    K1a call on the updated scene held against the plain march; and one
    step that trains the matrix (rot_perm dropped) at 64x64, after which
    K1a on the updated scene is held against the plain march too."""
    cfg = RenderConfig(resolution=RECOVERY_RES, max_raymarch=48,
                       max_raytrace=4, light_quality=1e9,
                       roulette=Roulette.EXP, omega=1.0,
                       omega_policy=OmegaPolicy.CONSTANT,
                       hit_criterion=HitCriterion.ABSOLUTE,
                       hit_precision=1e-4, march_t0=0.005, max_dis=100.0)
    env = ibl.white_sky(device=dev)
    cam = make_camera(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=40.0,
                      aspect=1.0, aperture=0.0, focus=1.0, device=dev)

    def sphere(albedo):
        return scenelib.make_scene([scenelib.ObjectSpec(
            SHAPE.SPHERE, position=(0, 0, 0), scale=(1, 1, 1),
            albedo=albedo, roughness=1.0)], device=dev)

    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    target = ptrain.render_pixels(sphere((0.2, 0.6, 0.8)), env, cam, pid,
                                  cfg, spp=8, sample_offset=10_000,
                                  differentiable=False)
    step = ptrain.make_sharded_train_step(
        env, cam, cfg, spp=2, param_filter=ptrain.albedo_only_filter)
    ts = ptrain.make_train_state(sphere((0.5, 0.5, 0.5)), ptrain.adam(
        ptrain.cosine_decay_schedule(0.08, RECOVERY_STEPS, alpha=0.05)))
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(RECOVERY_STEPS):
        ts, loss = step(ts, target)
        losses.append(float(loss))
    rec_s = time.perf_counter() - t0
    launches = dict(march_kernel.LAUNCHES)
    albedo = ts.scene.albedo[0].tolist()
    if not (statistics.mean(losses[-3:]) < 0.2 * losses[0]
            and max(abs(a - b) for a, b in zip(albedo, (0.2, 0.6, 0.8)))
            < 0.1 and launches["k1a"] > 0):
        raise AssertionError(f"8e: the albedo was not recovered: losses "
                             f"{losses}, albedo {albedo}, launches "
                             f"{launches}")
    log(f"[8e] albedo recovery 16x16, {RECOVERY_STEPS} steps on the card in "
        f"{rec_s:.2f} s: loss {losses[0]:.5f} -> "
        f"{statistics.mean(losses[-3:]):.5f} (last three), albedo "
        f"{[round(a, 4) for a in albedo]} against (0.2, 0.6, 0.8); K1a "
        f"launches {launches['k1a']}")

    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    cfg = grad_config(8)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    target = ptrain.render_pixels(scene, env, cam, pid, cfg, spp=1,
                                  sample_offset=10_000,
                                  differentiable=False)
    start = scene.replace(albedo=scene.albedo * 0.8)
    step = ptrain.make_sharded_train_step(
        env, cam, cfg, spp=1, param_filter=ptrain.material_only_filter)
    ts = ptrain.make_train_state(start, ptrain.adam(0.01))
    ts, _ = step(ts, target)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        ts, loss = step(ts, target)
    loss = float(loss)
    dt = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    launches = dict(march_kernel.LAUNCHES)
    mem = (torch.cuda.max_memory_allocated() - held) / 2**30
    if not (np.isfinite(loss) and launches["k1a"] > 0
            and not any(v for k, v in launches.items() if k != "k1a")):
        raise AssertionError(f"8e: loss {loss}, launches {launches}")
    o, d = primaries(cfg, cam)
    _, err = compare(ts.scene, o, d, cfg)
    log(f"[8e] train step, Cornell full {cfg.width}x{cfg.height}, 8 "
        f"bounces, materials "
        f"only, dual buffer: {dt:.4f} s/step over {TRAIN_TIMED_STEPS} "
        f"steps ({cfg.num_pixels / dt / 1e6:.4f} Msamples/s of the "
        f"differentiated buffer), peak device memory {mem:.3f} GiB above "
        f"what the steps began with, K1a "
        f"launches a step {launches['k1a'] / TRAIN_TIMED_STEPS:g}, loss "
        f"{loss:.6f}; card {card_line()}; K1a on the updated scene's "
        f"primaries bit-equal to the plain march")

    small = cfg.replace(resolution=(64, 64))
    step = ptrain.make_sharded_train_step(
        ibl.gradient_sky(device=dev), cam, small,
        param_filter=ptrain.param_mask({"matrix"}))
    ts = ptrain.make_train_state(scene, ptrain.adam(0.05))
    ts, _ = step(ts, torch.zeros((small.num_pixels, 3), device=dev))
    if torch.equal(ts.scene.matrix, scene.matrix) or any(
            p is not None for p in ts.scene.rot_perm):
        raise AssertionError("8e: the matrix step left the matrix or the "
                             "permutation records as they were")
    o, d = primaries(cfg, cam)
    compare(ts.scene, o, d, cfg)
    log(f"[8e] one step training the matrix (64x64, gradient sky): the "
        f"permutation records dropped, K1a on the updated scene's "
        f"{cfg.width}x{cfg.height} primaries bit-equal to the plain march")
    return dict(recovery_s=rec_s, losses=losses, albedo=albedo, s=dt,
                mem=mem, launches=launches["k1a"] / TRAIN_TIMED_STEPS)


def gradient_phases(dev):
    """8a-8e. Returns what the summary and the kernels line read."""
    scan = phase_scan_ad(dev)
    rep = phase_replay(dev)
    nee = phase_replay_nee(dev)
    worst = phase_replay_vs_scan(dev)
    train = phase_train(dev)
    log(f"[8] summary ({card_line()}): scan-AD 8 bounces {scan['s']:.4f} "
        f"s/step, {scan['msps']:.4f} Msamples/s, {scan['mem']:.3f} GiB; "
        f"replay 128 bounces {rep[True]['s']:.4f} s/step, "
        f"{rep[True]['msps']:.4f} Msamples/s, {rep[True]['mem']:.3f} GiB "
        f"(checkpoint off {rep[False]['s']:.4f} s/step, "
        f"{rep[False]['mem']:.3f} GiB); replay + NEE {nee['s']:.4f} "
        f"s/step, {nee['msps']:.4f} Msamples/s, {nee['mem']:.3f} GiB; "
        f"replay vs scan-AD rel {worst:.3e}; train step {train['s']:.4f} "
        f"s/step, {train['mem']:.3f} GiB")
    held = [scan["held"], rep["held"], nee["held"]]
    err = lambda k: max((h[k][1] for h in held if k in h), default=0.0)
    return dict(scan=scan, rep=rep, nee=nee, worst=worst, train=train,
                err_a=err("k1a"), err_b=err("k1b"))


def main():
    dev = phase_device()
    build_s = phase_build()
    err_2, k2_ms, k2_plain, k2_bound = phase_k2(dev)
    err_a, ka_ms, pa_ms, cornell_state = phase_kernel_vs_plain(dev)
    err_c, kc_ms, pc_ms, glass_state = phase_k1c_vs_plain(dev)
    err_b, times_b, states_b = phase_k1b_vs_plain(dev)
    err_d, kd_ms, pd_ms = phase_k1d_vs_plain(dev, glass_state)
    launch_a, ms_frame, msps, cornell_calls = phase_main_path(dev)
    k1b_paths_out = phase_k1b_paths(dev)
    analytic_calls = {"cornell 480x480": cornell_calls,
                      **{k: v[4] for k, v in k1b_paths_out.items()}}
    in_frame_ab = phase_in_frame_analytic(analytic_calls)
    del analytic_calls, cornell_calls
    k1b_frames = {k: v[:4] for k, v in k1b_paths_out.items()}
    del k1b_paths_out
    err_a = max(err_a, in_frame_ab["cornell 480x480"]["err"])
    err_b = max(err_b, in_frame_ab["tokyo 2880x1620"]["err"],
                in_frame_ab["engine 768x432"]["err"])
    launch_b = k1b_frames["tokyo 2880x1620"][2]
    launch_c, ms_frame_c, msps_c, glass_calls = phase_bunny_path(dev)
    launch_d, metal, metal_path, metal_calls = phase_metal_path(dev)
    mstate, e_c, e_d = phase_metal_state_vs_plain(*metal_path)
    in_frame = phase_in_frame(glass_calls, metal_calls)
    del glass_calls, metal_calls
    err_c = max(err_c, e_c, in_frame["glass 1920x1080, K1c"]["err"],
                in_frame["metal 3840x2160, K1c"]["err"])
    err_d = max(err_d, e_d, in_frame["glass 1920x1080, K1d"]["err"],
                in_frame["metal 3840x2160, K1d"]["err"])
    phase_golden(dev)
    phase_golden_demo(dev)
    mega_cornell, mega_minimal, cornell_rec = phase_megakernel_cornell(dev)
    mega_glass, _, glass_q99, glass_rec = phase_megakernel_glass(dev)
    mega_a, mega_cd = phase_megakernel_calls(cornell_rec, glass_rec)
    del cornell_rec, glass_rec
    err_a = max(err_a, mega_a["err"])
    err_c = max(err_c, mega_cd[f"{GLASS_CALLS}, K1c"]["err"])
    err_d = max(err_d, mega_cd[f"{GLASS_CALLS}, K1d"]["err"])
    goldens = phase_goldens_megakernel(dev)
    offline_s = phase_offline_app()
    nee = nee_phases(dev)
    grads = gradient_phases(dev)
    err_a = max(err_a, grads["err_a"])
    err_b = max(err_b, grads["err_b"])
    err_b = max(err_b, *(v["err"] for v in nee["ab"].values()))
    err_c = max(err_c, nee["cd"]["glass NEE shadow, K1c"]["err"])
    err_d = max(err_d, nee["cd"]["glass NEE shadow, K1d"]["err"])
    demo_label = "scene_demo (ROLLBACK_TO_ONE + RELATIVE)"
    kb_ms, pb_ms = times_b[demo_label]

    glass, go, gd, ginit, gcfg = glass_state
    states = {"k1a": cornell_state, "k1b": states_b[demo_label],
              "k1c": glass_state,
              "k1d": (glass, go, gd, ginit, gcfg.replace(bunny_mxu=True)),
              "k1c metal": mstate,
              "k1d metal": mstate[:4] + (mstate[4].replace(bunny_mxu=True),)}
    launch_2, roof, bounds = phase_utilization(dev, states)

    frame = lambda k: in_frame[k]["ms"] / 4
    log(f"[6] summary: build {build_s:.2f} s; K2 roof {roof / 1e9:.1f} "
        f"GFLOP/s; Cornell {ms_frame:.3f} ms/frame, {msps:.4f} Msamples/s; "
        f"bunny glass {ms_frame_c:.3f} ms/frame, {msps_c:.4f} Msamples/s; "
        f"metal 4K K1c {metal[False][0][0]:.3f} / K1d {metal[True][0][0]:.3f}"
        f" ms/frame; per budget-32 call: K1a {ka_ms:.4f}, K1b {kb_ms:.4f}, "
        f"K1c {kc_ms:.4f}, K1d {kd_ms:.4f} ms; a call inside the frames: "
        f"K1c glass {frame('glass 1920x1080, K1c'):.4f}, metal "
        f"{frame('metal 3840x2160, K1c'):.4f}; K1d glass "
        f"{frame('glass 1920x1080, K1d'):.4f}, metal "
        f"{frame('metal 3840x2160, K1d'):.4f} ms; " + "; ".join(
            f"{k} {v[0]:.3f} ms/frame, {v[1]:.4f} Msamples/s, K1b "
            f"{in_frame_ab[k]['device_ms'] / 4:.4f} ms a call back to back"
            for k, v in k1b_frames.items())
        + f"; K1a in the Cornell frame "
        f"{in_frame_ab['cornell 480x480']['device_ms'] / 4:.4f} ms a call "
        f"back to back")
    glass_ms = lambda mxu: statistics.mean(v["ms"] for v in mega_glass[mxu])
    log(f"[6] megakernel: Cornell full 480x480 {mega_cornell['msps']:.4f} "
        f"Msamples/s ({mega_cornell['ms']:.3f} ms/pass, "
        f"{mega_cornell['bounces']:.1f} bounces, {mega_cornell['syncs']} "
        f"host syncs a pass); Cornell minimal 512x512 "
        f"{mega_minimal['ms']:.3f} ms/pass ({mega_minimal['bounces']:.1f} "
        f"bounces); glass 1920x1080 K1c {glass_ms(False):.3f} / K1d "
        f"{glass_ms(True):.3f} ms/pass "
        f"({mega_glass[False][0]['bounces']:.1f} bounces, 99% of lanes "
        f"stopped by bounce {glass_q99}); nine goldens "
        + ", ".join(f"{k} {v[0]:.2f}" for k, v in goldens.items())
        + f" dB; offline app {offline_s:.1f} s")
    entry = lambda name, source, line, n, err, k, p, b: {
        "name": name, "route": "cuda", "source": f"{CSRC}/{source}",
        "replaces": line, "launches": n, "max_abs_err": err, "ms": k,
        "plain_ms": p, "bound_ms": b[0], "bound_by": b[1],
        # no single PyTorch call computes a sphere trace or an FMA chain
        "library_ms": None}
    bound = lambda k: (bounds[k]["bound_ms"], bounds[k]["bound_by"])

    def pooled(e, key, frames):
        """K1c's or K1d's entry with its MLP work on phase 5's glass state
        and the mean call inside the frames."""
        u = bounds[key]
        e.update(support_lane_iters=u["support_lane_iters"],
                 mlp_lane_iters_executed=u["mlp_lane_iters_executed"],
                 in_frame_ms={f: frame(f) for f in frames})
        return e

    def analytic(e, frames):
        """K1a's or K1b's entry with the mean call inside its frames: a
        call alone, and back to back (the kernel's own time)."""
        e.update(in_frame_ms={f: in_frame_ab[f]["ms"] / 4 for f in frames},
                 in_frame_device_ms={f: in_frame_ab[f]["device_ms"] / 4
                                     for f in frames})
        return e

    def megakernel(e, per_pass, calls):
        """The entry with its launches a megakernel pass and its 3j calls'
        time (K1a: back to back), bound and share."""
        ms = calls.get("device_ms", calls["ms"])
        e["megakernel"] = {"launches_per_pass": per_pass,
                           "calls_ms": ms, "calls_bound_ms": calls["bound_ms"],
                           "calls_share": calls["bound_ms"] / ms}
        return e
    k1b_goldens = sum(goldens[k][1] for k in ("cornell_v3", "scene_demo",
                                              "tokyo"))

    def shadow_frames(e):
        """K1b's entry with the NEE frames' shadow calls (7d): back to
        back, bound and share, and the shadow launches a frame (7b) and a
        Cornell NEE pass (7c) in the timed runs."""
        e["nee_shadow"] = {
            k: {"calls_ms": v["device_ms"], "calls_bound_ms": v["bound_ms"],
                "calls_share": v["bound_ms"] / v["device_ms"],
                "launches_per_frame": nee["per_frame"][k]}
            for k, v in nee["ab"].items()}
        e["nee_shadow"]["cornell 480x480 NEE megakernel"] = {
            "launches_per_pass": nee["corn"]["shadow_per_pass"]}
        return e

    def shadow_pass(e, label, mxu):
        """K1c's or K1d's entry with the glass NEE pass's recorded shadow
        calls (7d) and the shadow launches a pass in 7c's timed runs."""
        v = nee["cd"][label]
        e["nee_shadow"] = {"calls_ms": v["ms"],
                           "calls_bound_ms": v["bound_ms"],
                           "calls_share": v["bound_ms"] / v["ms"],
                           "launches_per_pass": nee["per_pass"][mxu]}
        return e
    # the gradient paths' launches a step (8a-8c) and a train step (8e)
    g_a = {"gradients": {"launches_per_step": {
        "scan-AD 8 bounces": grads["scan"]["launches"]["k1a"],
        "replay 128 bounces": grads["rep"][True]["launches"]["k1a"],
        "replay 128 bounces, no checkpoint":
            grads["rep"][False]["launches"]["k1a"],
        "replay + NEE 128 bounces": grads["nee"]["launches"]["k1a"],
        "train step 8 bounces": grads["train"]["launches"]}}}
    g_b = {"gradients": {"launches_per_step": {
        "replay + NEE 128 bounces (shadow)":
            grads["nee"]["launches"]["k1b"]}}}
    log(json.dumps({"kernels": [
        megakernel(analytic(entry("march_k1a", "march.cu",
                                  f"{TPU_KERNEL}:297", launch_a, err_a,
                                  ka_ms, pa_ms, bound("k1a")),
                            ("cornell 480x480",)),
                   mega_cornell["bounces"], mega_a) | g_a,
        shadow_frames(analytic(entry("march_k1b", "march.cu",
                                     f"{TPU_KERNEL}:338", launch_b, err_b,
                                     kb_ms, pb_ms, bound("k1b")),
                               ("tokyo 2880x1620", "engine 768x432"))
                      | {"megakernel": {"golden_launches": k1b_goldens}}
                      | g_b),
        shadow_pass(megakernel(
            pooled(entry("march_k1c", "march.cu", f"{TPU_KERNEL}:156",
                         launch_c, err_c, kc_ms, pc_ms, bound("k1c")), "k1c",
                   ("glass 1920x1080, K1c", "metal 3840x2160, K1c")),
            mega_glass[False][0]["bounces"], mega_cd[f"{GLASS_CALLS}, K1c"]),
            "glass NEE shadow, K1c", False),
        shadow_pass(megakernel(
            pooled(entry("march_k1d", "march_mxu.cu", f"{TPU_KERNEL}:124",
                         launch_d, err_d, kd_ms, pd_ms, bound("k1d")), "k1d",
                   ("glass 1920x1080, K1d", "metal 3840x2160, K1d")),
            mega_glass[True][0]["bounces"], mega_cd[f"{GLASS_CALLS}, K1d"]),
            "glass NEE shadow, K1d", True),
        entry("fma_chains_k2", "speedlight.cu",
              "raytracingpbr_tpu/utils/speedlight.py:94", launch_2, err_2,
              k2_ms, k2_plain, (k2_bound, "operations"))]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
