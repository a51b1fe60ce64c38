#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises and exits non-zero):

0.  device: the card's name and power limit, torch / CUDA versions,
    CUDA_HOME, whether triton imports, TF32 matmuls off. No card: fail (no
    CPU fallback).
1.  build every kernel from ``raytracingpbr_tpu_torch/csrc``, one nvcc per
    source started together (march.cu: K1a, K1b, K1c; march_mxu.cu: K1d;
    speedlight.cu: K2; rng.cu: the counter RNG; normal.cu: the analytic
    normal), and print what
    ``-Xptxas -v`` says of each library and the persistent grid of K1c
    and K1d.
11. the bench, right after the build: ``python3 bench_torch.py`` and
    ``python3 tools/bench_workloads_torch.py`` as fresh processes, as a
    user runs them: rc 0; ``bench.py``'s eleven keys and ``device``, every
    number finite and above 0, the card's name and power limit as
    ``nvidia-smi`` gives them; the headline's K1a launches 4 a frame and
    no other march kernel (from the run's record line on stderr); the six
    rows at their native resolution, each in the table. Then
    ``bench.nee_equal_time`` and ``bench.adaptive_payoff`` in this process
    at a tenth of the JAX scripts' budgets and frame counts: K1a and K1b
    (the shadow rays alone), K1a alone; every number finite (the adaptive
    bench's gate does no work at a tenth of its frames: 9c holds it).
    Then the paths no other phase marches, one frame each, every march
    call bit-equal to the plain march: NEE's sun-lit spheres at 160x160
    (K1a bounces, K1b shadow rays) and the Cornell minimal 512x512 row.
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
8f. scan-AD through the neural bunny at full width: ``glass_config`` at
    1920x1080 (omega 0.5, RELATIVE, 2048 trips, the HDR sky), 8 bounces,
    spp 1, the MSE against zeros, the gradients of the MLP's eight
    tensors, the matrix and the albedo (``_hit_t``'s backward through the
    MLP, the normal at second order), on 8a's protocol with
    ``bunny_mxu`` off (K1c alone) and on (K1d alone): s/step, Msamples/s,
    peak memory, launches and host syncs a step, one profiled step; every
    gradient finite and nonzero; every march call of one step, as made,
    held on every GLASS_SUBSET-th lane against the plain march on the
    scene as it stood (K1c bit-equal, K1d the march bar), the kernel timed
    on the whole calls and on the subsets, the subsets' bound; the step on
    a 240x135 crop with K1c against the same step with the plain march
    (rtol 1e-5; the albedo's, small differences of large sums, 1e-4);
    K1d's against K1c's on the crop, under BUNNY_MXU_SPREAD of K1c's own
    difference between two samples there.
8g. training the bunny's MLP with ``param_mask(set())`` (the object
    buffers frozen, the MLP trained, K1c): the recovery of an output bias
    shifted by BUNNY_BIAS_SHIFT at BUNNY_RECOVERY_RES (the loss falls by
    BUNNY_LOSS_DROP at least, the bias nears its true value); then 1 +
    TRAIN_TIMED_STEPS timed steps at 1920x1080, s/step and peak memory,
    and every march call of the step after them held, as made, against
    the plain march on the updated scene (the pack-cache check).

9c. adaptive frame compaction: the Cornell main path at 480x480 with
    ``adaptive_sampling`` at the noise threshold ADAPTIVE_THRESHOLD,
    ADAPTIVE_FRAMES frames through ``render_frame_tile`` compacted every
    ADAPTIVE_EVERY frames (``ops/compact``) against as many uncompacted,
    in turns off, on, on, off: the scattered raster and the uncompacted
    state bit-identical; a compaction moved lanes, and at least
    10% of pixels were inactive at the last one; ms/frame each way, the
    compactions' ms, the inactive share per frame.
9d. reprojection: the interactive app's session (``apps.interactive``) on
    the engine scene at 768x432 through a scripted list of moves and
    rotations with ``--reproject`` and without, in turns: ms a frame, the
    frames that reprojected, K1b's launches; ``reproject``'s own ms (CUDA
    events); ``reproject`` on the card against the CPU on the same state
    (the accumulator within rtol 1e-5 on at least 99.9% of pixels: the
    card's atomic adds reorder a pixel's sums; the depths bit-equal);
    ``tests/test_reproject.py``'s
    reprojection-beats-zero-reset property at full width, on its minimal
    Cornell box at 512x512 in the mean radiance error and on the engine
    frames at 768x432 in the tonemapped image and the median pixel's
    radiance error (the mean radiance error printed beside).
9e. the progressive daemon in a subprocess, through ``progressive.run``
    as ``--scene cornell --adaptive --compact-every 4 --serve 0`` calls it
    but with the noise threshold at 0.15, for SERVE_MINUTES; /frame.png
    and /stats fetched over localhost while it runs; rc 0; a compaction
    moved lanes (the metrics' ``lanes_moved``); the saved ``final.png``
    equal to the raster of the saved checkpoint's pixels.

10a. sharded stills: ``parallel/render.render_image_sharded`` on the
    Cornell full box at 480x480, spp 4, in one process, on the meshes
    (8, 1) contiguous and strided, (4, 2) and (2, 4): tiles-only meshes
    bit-identical to ``render_image``, sample meshes within atol 1e-5 /
    rtol 1e-4; ms a pass of each next to the unsharded pass; K1a alone;
    every K1a call of one (4, 2) and one (2, 4) render (a sample a rank)
    held bit-equal to the plain march.
10b. sharded frames: the Cornell main path, 4 frames through
    ``render_frame_sharded`` on (8, 1) contiguous and strided, pixels and
    accumulator bit-identical to ``render_frame``; the engine at 768x432
    with ``cfg.reprojection`` on (8, 1) strided (3 frames, a 0.08 move, a
    reprojected refresh) within rtol 1e-5 on 99.9% of pixels (PR 9's bar:
    the warp's atomics); the adaptive gate at ADAPTIVE_THRESHOLD over 8
    frames, the same pixels stopped.
10c. processes: ``python -m raytracingpbr_tpu_torch.apps.multihost
    --device cuda --backend gloo`` in a subprocess, two processes sharing
    the card with 4 ranks each of (8, 1) (Cornell full 480x480, spp 2),
    bit-identical to one process, and 3 train steps on (4, 2) within rtol
    1e-5; then a one-process NCCL group through ``multihost.work``, its
    all_gathers called, equal to the group-less mesh.
10d. scaling: ``parallel/scaling.measure`` on (8, 1) contiguous and
    strided (the Cornell main path at 480x480): the per-tile table and the
    imbalance of each layout, in time and in the longest primary march.
10e. the train step on the (4, 2) mesh at full width (Cornell full
    480x480, 8 bounces, albedo only): 1 + 5 timed steps, s/step next to
    8e's; every K1a call of one step held bit-equal to the plain march; a
    1 x 1 mesh's step, and ``mesh=None``'s, against the one-card step
    written out (loss bit-identical, the scene within rtol 1e-5:
    atomics).
10f. ``apps.denoise_demo.run`` at 768x432 on the card, 100 steps timed, 10
    held within 1e-5 of the CPU; ``scene.calc_normal_tetrahedron`` on the
    card against the CPU; how often the card's division by a host scalar
    (a multiply by its reciprocal) rounds apart from the CPU's, against a
    divisor that is a tensor on the card.
12. the counter RNG kernel (``csrc/rng.cu``): alone at 230,400 and
    2,073,600 lanes (``uniform4`` and ``uniform`` with the step on the
    card, ``r2_uniform4`` with one a lane), back to back on inputs the L2
    does not hold, against its byte bound, the plain draw beside it; one
    glass frame at 1920x1080 with every draw recorded (3 a step, one
    launch each) and held bit-equal to the plain draw, and the same frame
    with the plain draws bit-identical in pixels and state; one scan-AD
    step of the Cornell box at 8 bounces with every draw held, its albedo
    gradient within rtol 1e-5 of the plain draws' step.
13. the analytic normal kernel (``csrc/normal.cu``): alone on the primary
    hits of tokyo at 2880x1620 (4,665,600 lanes, K1b) and of the Cornell
    box at 480x480 (230,400, K1a), back to back over four copies of the
    inputs, against its byte bound, beside ``calc_normal_closed_plain``
    and autograd's normal, every lane bit-equal to autograd's; one tokyo
    frame at 2880x1620 and one Cornell frame at 480x480 with the kernel
    and with autograd's normal in its place, pixels and state
    bit-identical, the kernel's launches a frame.
14. the material gradient kernel (``csrc/material_grad.cu``): alone at
    the glass step's 2,073,600 lanes on its one object (the albedo alone,
    and all six parts) and at the Cornell step's 230,400 lanes over its 8
    objects (the albedo), back to back over four copies of the inputs,
    against its byte bound, beside the plain backward (an ``index_add_``
    a part) and ``index_select``'s backward as the gather ran it before
    (``library_ms``), within 1e-5 of a float64 sum's absolute size; one
    Cornell scan-AD step at 480x480 and one glass step at 1920x1080, 8
    bounces each, with the kernel's calls, ``materials_at``'s routes and
    the normals' routes counted.

The protocols that time frames, passes and steps (3, 3b, 3c, 3f, 3g-3i,
7b, 7c, 8a-8c, 8f) are ``raytracingpbr_tpu_torch/bench.py``'s, as are
the workload rows' configurations. Each path's launch counts are set to 0
just before it and read just after.
The last lines are the kernels' JSON record (K1a and K1b with their mean
call inside their frames, a call alone and back to back; K1c and K1d with
theirs; K1a, K1c and K1d with their launches a megakernel pass and their
3j calls' time, bound and share, K1b with its launches in the goldens;
K1b, K1c and K1d with their 7d shadow calls' time, bound, share and
launches; K1a and K1b with their launches a step on the gradient paths; K1c and
K1d with their launches a bunny scan-AD step (8f) and K1c a bunny train
step (8g), and the 8f step's calls' time, bound and share;
K1a with its launches a frame in 9c, K1b with its launches a frame in
9d; K1a with its sharded paths' launches in 10a-10e, K1b with the
reprojected engine frame's in 10b; K1a, K1b, K1c and K2 with the bench's
launches in 11, by source; the RNG kernel with its launches and draws in
12's frame and step, its times alone against its bound, and the bench's
launches by source; the normal kernel with its launches a frame and its
times alone against its bound, 13; the material gradient kernel with its
calls a step and its times alone against its bound, 14),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
Imports no jax.
"""
import dataclasses
import functools
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from raytracingpbr_tpu_torch import (HitCriterion, OmegaPolicy, RenderConfig,
                                     Roulette, bench, make_camera)
from raytracingpbr_tpu_torch.apps import (denoise_demo, interactive,
                                          multihost, progressive)
from raytracingpbr_tpu_torch.bench import (albedo_grad, bunny_config,
                                           card_line, grad_config, k1b_paths,
                                           metal_config, sun_sky)
from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.io import checkpoint as ckpt
from raytracingpbr_tpu_torch.io import image as imageio
from raytracingpbr_tpu_torch.io.image import read_png
from raytracingpbr_tpu_torch.kernels import (build, fma_kernel, march_kernel,
                                             material_grad_kernel,
                                             normal_kernel, rng_kernel)
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.models.goldens import GOLDENS, render_golden
from raytracingpbr_tpu_torch.ops import ibl, integrator, march
from raytracingpbr_tpu_torch.ops import compact as compactlib
from raytracingpbr_tpu_torch.ops import post as postlib
from raytracingpbr_tpu_torch.ops import reproject as reprojectlib
from raytracingpbr_tpu_torch.ops import scene as scenelib
from raytracingpbr_tpu_torch.ops.integrator import (render_frame,
                                                    render_image,
                                                    render_image_progressive)
from raytracingpbr_tpu_torch.ops.sdf import SHAPE, BunnyMLP, bunny_mlp_eval
from raytracingpbr_tpu_torch.parallel import mesh as pmesh
from raytracingpbr_tpu_torch.parallel import render as prender
from raytracingpbr_tpu_torch.parallel import scaling as pscaling
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
# the bunny's gradients (8f, 8g): the buffers differentiated; the crop of
# the frame whose whole step is held against the plain march's; K1d's step
# against K1c's on the crop: each gradient's relative difference (norm
# over norm) under this share of K1c's own difference between two sample
# sets; the MLP's recovery: its size, steps, Adam's rate (cosine decay),
# the output bias's shift, the samples a step and the target's, and the
# least factor by which the loss must fall (the first step's over the
# last ten's mean: a step's unbiased loss under the HDR sky is noisy)
BUNNY_GRAD_FIELDS = tuple("bunny_" + k for k in BunnyMLP._fields) + (
    "matrix", "albedo")
BUNNY_CROP = (240, 135)
BUNNY_MXU_SPREAD = 0.25
BUNNY_RECOVERY_RES = (64, 36)
BUNNY_RECOVERY_STEPS = 30
BUNNY_RECOVERY_LR = 3e-4
BUNNY_BIAS_SHIFT = 0.01
BUNNY_RECOVERY_SPP = 8
BUNNY_TARGET_SPP = 256
BUNNY_LOSS_DROP = 2.0
# compaction and reprojection (9c-9e): the adaptive frames, compacted every ADAPTIVE_EVERY at
# the noise threshold (about 90% of the Cornell pixels fall below it by
# the sixth frame, so later compactions move lanes); the interactive
# app's script (moves and rotations); the preview daemon's run
ADAPTIVE_FRAMES = 16
ADAPTIVE_EVERY = 4
ADAPTIVE_THRESHOLD = 0.15
REPROJECT_SCRIPT = ("w", "w", "d", "l", "u", "s", "r", "a", "n", "w", "d",
                    "l")
SERVE_MINUTES = 0.15
# distributed (10a-10f): the sharded stills' meshes and samples per pixel;
# the sharded frames, and the adaptive gate's (ADAPTIVE_THRESHOLD stops
# pixels from the sixth frame on); the scaling report's timed frames a
# tile; the mesh train step's timed steps; the denoise demo's timed steps
# and the steps held against the CPU
SHARDED_MESHES = ((8, 1, "contiguous"), (8, 1, "strided"),
                  (4, 2, "contiguous"), (2, 4, "contiguous"))
SHARDED_SPP = 4
SHARDED_FRAMES = 4
SHARDED_ADAPTIVE_FRAMES = 8
SCALING_ITERS = 3
MESH_TRAIN_STEPS = 5
DENOISE_STEPS = 100
DENOISE_HELD = 10
# the bench (11): the entry points' time limit as subprocesses (s); the
# share of the NEE and adaptive benches' budgets and frames run here
BENCH_TIMEOUT = 600
BENCH_SHARE = 10
# the RNG kernel alone (12): the Cornell and glass frames' lanes, the
# launches timed back to back, the card's memory bandwidth (B/s)
RNG_LANES = (230_400, 2_073_600)
RNG_REPS = 100
HBM_BYTES_PER_S = 3.35e12
# the normal kernel alone (13): launches timed back to back
NORMAL_REPS = 100
# the material gradient kernel alone (14): (label, lanes, objects, the
# parts needing a gradient); calls timed back to back
MATERIAL_CASES = (
    ("glass step, albedo", 2_073_600, 1, ("albedo",)),
    ("glass step, all six parts", 2_073_600, 1,
     material_grad_kernel.PART_NAMES),
    ("Cornell step, albedo", 230_400, 8, ("albedo",)))
MATERIAL_REPS = 100


def log(*a):
    print(*a, flush=True)


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
    rng_kernel.load()
    normal_kernel.load()
    secs = time.perf_counter() - t0
    libs = ", ".join(os.path.relpath(p, REPO) for p in paths.values())
    log(f"[1] built {libs} in {secs:.2f} s (one nvcc per source, in parallel)")
    for name, label in (("march", "K1a-K1c"), ("march_mxu", "K1d"),
                        ("speedlight", "K2"), ("rng", "the RNG"),
                        ("normal", "the normal")):
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
    cfg = bench.headline_config()
    scene = cornell.full_scene(dev)
    mcfg = cfg.replace(max_raymarch=cfg.march_split)
    o, d = bench.utilization_rays(cfg, cornell.full_camera(dev))

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
    o, d = bench.utilization_rays(
        ccfg, bunny.camera(ccfg.width / ccfg.height, dev))
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
        o, d = bench.utilization_rays(cfg, demo.engine_camera(dev))
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
    o, d = bench.utilization_rays(
        mcfg, bunny.camera(mcfg.width / mcfg.height, dev))
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
    """``bench.wavefront``'s protocol from a fresh state: 1 + 3 warm-up
    frames, 10 timed, ending in a sync; ``kind``'s kernel must launch
    ``per_step`` times a step (2 with NEE: the bounce and the shadow rays)
    and no other march kernel at all (``bench.check_frame_launches``).
    Returns (ms/frame, Msamples/s, launches, state)."""
    r = bench.wavefront(scene, env, cam, cfg, 3, TIMED_FRAMES)
    bench.check_frame_launches(label, r, cfg, kind, per_step)
    c1 = bench.sample_count(r["state"])
    check_frame(r["pixels"], c1 - r["samples"], c1)
    n = r["launches"]["march"][kind]
    log(f"{label}: first frame {r['first_s']:.2f} s; {r['ms']:.3f} ms/frame, "
        f"{r['msps']:.4f} Msamples/s, {n} {kind} launches in {r['frames']} "
        f"frames, {r['launches']['bound'][kind]} of them escape-bound")
    return r["ms"], r["msps"], n, r["state"]


def phase_main_path(dev):
    """The Cornell frames, then one more whose four march calls are
    recorded (3e)."""
    cfg = bench.headline_config()
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
    """``bench.megakernel``'s protocol (``bench.py:88-108``):
    ``render_image(spp=1, tonemapped=False)`` at sample_offset ``first -
    1`` as warm-up (unless ``warm`` is False), then ``passes`` timed passes
    at sample offsets ``first``, ``first + 1``, ... ending in a sync.
    Only ``kind``'s march kernel may launch, one launch a bounce (``kind``
    may be a tuple: the bounce's kernel first, then the shadow rays', each
    of which must launch); the shadow rays' launches are the escape-bound
    ones, which run exactly when ``cfg.env_sampling`` is on. Returns ms/pass,
    Msamples/s, bounces the loop ran a pass, the launches, shadow launches
    a pass, peak GiB and the last image."""
    kinds = (kind,) if isinstance(kind, str) else tuple(kind)
    r = bench.megakernel(scene, env, cam, cfg, passes, first, warm, **kw)
    warm, dt, img = r["warm_s"], r["ms"] / 1e3, r["img"]
    launches, bound = r["launches"]["march"], r["launches"]["bound"]
    bench.check_kinds(label, r["launches"], kinds)
    shadow = sum(bound.values())
    if bool(shadow) != cfg.env_sampling:
        raise AssertionError(f"{label}: escape-bound launches {bound} with "
                             f"env_sampling={cfg.env_sampling}")
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0):
        raise AssertionError(f"{label}: the image is not finite and positive")
    # a bounce launches kinds[0] once; the shadow rays' launches are the
    # escape-bound ones
    bounce_launches = launches[kinds[0]] - bound[kinds[0]]
    out = dict(ms=r["ms"], msps=r["msps"],
               bounces=bounce_launches / passes,
               launches=launches[kinds[0]],
               all_launches={k: launches[k] for k in kinds},
               shadow_per_pass=shadow / passes, mem=r["mem_gib"], img=img)
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
    o, d = bench.utilization_rays(cfg, cornell.full_camera(dev))
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


def fwd_bwd(label, scene, env, cam, cfg, mode, kinds, steps=GRAD_STEPS,
            grads=None):
    """``bench.timed_steps``' fwd+bwd protocol (``bench.py:110-152``): one
    warm-up step (sample 0), then ``steps`` timed steps (samples
    1..steps) ending in a sync. The launch counts are set to 0 before the
    timed steps and read after: only
    ``kinds`` may launch, each at least once. ``grads``: the step, ``s ->
    {name: gradient}`` (default the albedo's, :func:`albedo_grad`), each
    gradient finite and nonzero. Returns s/step, Msamples/s (pixels /
    s/step), the steps' peak GiB (above what was allocated before them),
    launches a step and the last gradients (``grad`` the first)."""
    if grads is None:
        grads = lambda s: {"albedo": albedo_grad(scene, env, cam, cfg, mode,
                                                 s)}
    r = bench.timed_steps(grads, steps, scene.device)
    warm, dt, gs = r["warm_s"], r["s"], r["grads"]
    launches = r["launches"]["march"]
    shadow = sum(r["launches"]["bound"].values())
    bench.check_kinds(label, r["launches"], kinds)
    if bool(shadow) != cfg.env_sampling:
        raise AssertionError(f"{label}: escape-bound launches {shadow} with "
                             f"env_sampling={cfg.env_sampling}")
    bench.check_grads(label, gs)
    out = dict(s=dt, msps=cfg.num_pixels / dt / 1e6, mem=r["mem_gib"],
               launches={k: launches[k] / steps for k in kinds},
               shadow=shadow / steps, grad=next(iter(gs.values())),
               grads=gs)
    log(f"[{label}] warm-up step {warm:.2f} s; {dt:.4f} s/step, "
        f"{out['msps']:.4f} Msamples/s over {steps} steps; peak device "
        f"memory {out['mem']:.3f} GiB above the {r['held_gib']:.3f} held "
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


def hold_calls(label, calls, what="step"):
    """Each recorded call bit-equal to the plain march (kernel and plain
    both run anew on the recorded inputs); ``what`` names the recorded run
    in the log line. Returns {kind: (calls, max abs err)}."""
    out = {}
    for sc, (o, d, a, i, c) in calls:
        kind = march_kernel.variant(sc, c)
        _, err = compare(sc, o, d, c, a, i)
        n, e = out.get(kind, (0, 0.0))
        out[kind] = (n + 1, max(e, err))
    log(f"[{label}] every march call of one {what} bit-equal to the plain "
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
    o, d = bench.utilization_rays(cfg, cam)
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
    o, d = bench.utilization_rays(cfg, cam)
    compare(ts.scene, o, d, cfg)
    log(f"[8e] one step training the matrix (64x64, gradient sky): the "
        f"permutation records dropped, K1a on the updated scene's "
        f"{cfg.width}x{cfg.height} primaries bit-equal to the plain march")
    return dict(recovery_s=rec_s, losses=losses, albedo=albedo, s=dt,
                mem=mem, launches=launches["k1a"] / TRAIN_TIMED_STEPS)


# --- the bunny's gradients: scan-AD through K1c and K1d, training the MLP ----


def bunny_step(scene, env, cam, cfg, s, pixel_id=None):
    """One fwd+bwd step on the bunny: ``render_pixels`` at spp 1 by scan-AD,
    sample offset ``s``, the MSE against zeros over ``pixel_id`` (every
    pixel), the gradients of BUNNY_GRAD_FIELDS (the MLP's eight tensors,
    the matrix, the albedo) by name."""
    pid = (torch.arange(cfg.num_pixels, dtype=torch.int64,
                        device=scene.device)
           if pixel_id is None else pixel_id)
    names = scenelib.param_names(scene)
    leaves = [v.detach().clone().requires_grad_(k in BUNNY_GRAD_FIELDS)
              for k, v in zip(names, scenelib.params(scene))]
    img = ptrain.render_pixels(scenelib.with_params(scene, leaves), env, cam,
                               pid, cfg, spp=1, sample_offset=s)
    grads = torch.autograd.grad(torch.mean(img ** 2),
                                [v for v in leaves if v.requires_grad])
    return dict(zip([k for k in names if k in BUNNY_GRAD_FIELDS], grads))


def record_as_made(fn, sub=GLASS_SUBSET):
    """Runs ``fn()`` with every march kernel call recorded as it was made:
    the scene's float buffers as they stood (cloned after the launch, on
    its stream), the whole call's inputs, and its inputs and the kernel's
    outputs on every ``sub``-th lane (a lane's march is its own, so the
    kernel's outputs there are those of the kernel on those lanes alone).
    Returns ``(fn's result, [dict(scene, whole, part, out, cfg)])``."""
    real = march_kernel.march_resumable_cuda
    calls = []
    copy = lambda v, k=slice(None): None if v is None else v[k].clone()

    def record(sc, o, d, c, active=None, init=None, **k):
        out = real(sc, o, d, c, active=active, init=init, **k)
        lanes = slice(None, None, sub)
        snap = scenelib.with_params(sc, [v.detach().clone()
                                         for v in scenelib.params(sc)])
        ini = (lambda k: None if init is None else
               tuple(copy(v, k) for v in init))
        calls.append(dict(
            scene=snap, cfg=c,
            whole=(copy(o), copy(d), copy(active), ini(slice(None))),
            part=(copy(o, lanes), copy(d, lanes), copy(active, lanes),
                  ini(lanes)),
            out=march.ResumableResult(*(copy(v, lanes) for v in out))))
        return out
    result = with_march(fn, record)
    torch.cuda.synchronize()
    return result, calls


def hold_as_made(label, calls, time_calls=False):
    """Each recorded call's kernel outputs on its lane subset against the
    plain march on the same inputs and the scene as it stood: K1c
    bit-equal on all eight outputs, K1d within ``march.assert_march_close``.
    With ``time_calls``: the kernel timed on the whole call and on the
    subset (median of 3, CUDA events), and the subset's bound
    (``utils/speedlight.march_bound``, its MLP support counted by the same
    plain march). Returns the sums: calls, max abs err, ms whole, ms and
    bound on the subset, lane-trips needed."""
    tot = dict(calls=0, err=0.0, ms=0.0, sub_ms=0.0, bound_ms=0.0,
               needed=0, active=0, lanes=0)
    kinds = set()
    for call in calls:
        sc, c, k = call["scene"], call["cfg"], call["out"]
        o, d, a, i = call["part"]
        kind = march_kernel.variant(sc, c)
        kinds.add(kind)
        plain = []
        support, _ = speedlight.support_lane_trips(sc, o, d, c, a, i,
                                                   plain=plain)
        p = plain[0]
        if kind == "k1d":
            err = march.assert_march_close(sc, o, d, k, p, c)[0]
        else:
            bad = {f: int((x != y).sum()) for f, x, y in zip(FIELDS, k, p)}
            if any(bad.values()):
                raise AssertionError(f"[{label}] a call's kernel outputs "
                                     f"differ from the plain march: {bad}")
            err = 0.0
        tot["calls"] += 1
        tot["err"] = max(tot["err"], err)
        tot["needed"] += int(k.fin.to(torch.int64).sum())
        if time_calls:
            wo, wd, wa, wi = call["whole"]
            tot["ms"] += median_ms(lambda: march_kernel.march_resumable_cuda(
                sc, wo, wd, c, active=wa, init=wi), 3)
            tot["sub_ms"] += median_ms(
                lambda: march_kernel.march_resumable_cuda(
                    sc, o, d, c, active=a, init=i), 3)
            tot["bound_ms"] += speedlight.march_bound(
                sc, c, k.fin, support, a, i)["bound_ms"]
            tot["active"] += int(wa.sum()) if wa is not None else wo.shape[0]
            tot["lanes"] += wo.shape[0]
    timed = (f"; the kernel {tot['ms']:.4f} ms on the whole calls "
             f"({tot['lanes']} lanes, {tot['active']} active), "
             f"{tot['sub_ms']:.4f} ms on the subsets against a bound of "
             f"{tot['bound_ms']:.4f} ms "
             f"({100 * tot['bound_ms'] / max(tot['sub_ms'], 1e-9):.2f}%)"
             if time_calls else "")
    log(f"[{label}] the {tot['calls']} march calls of one step as made, "
        f"every {GLASS_SUBSET}th lane: "
        + ", ".join(k.upper() for k in sorted(kinds))
        + (" within the march bar (max |dt| held "
           f"{tot['err']:.3e})" if kinds == {"k1d"} else
           " bit-equal to the plain march")
        + f"; lane-trips needed on the subsets {tot['needed']}{timed}")
    return tot


def rel_diff(a, b):
    """|a - b| / |b| in the Frobenius norm."""
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def with_march(fn, march_fn):
    """``fn()`` with the card's march calls sent to ``march_fn`` (the plain
    march on the same CUDA tensors, for a comparison)."""
    real = march_kernel.march_resumable_cuda
    march_kernel.march_resumable_cuda = march_fn
    try:
        return fn()
    finally:
        march_kernel.march_resumable_cuda = real


def plain_march(sc, o, d, c, active=None, init=None, **k):
    return tuple(march.march_resumable_plain(sc, o, d, c, active, init))


def phase_bunny_scan_ad(dev):
    """8f: scan-AD through the glass bunny at full width (``glass_config``
    1920x1080, omega 0.5, RELATIVE, 2048 trips, the HDR sky), 8 bounces,
    spp 1, the MSE against zeros, the gradients of the MLP's eight
    tensors, the matrix and the albedo, on ``fwd_bwd``'s protocol with
    ``bunny_mxu`` off (K1c alone launches) and on (K1d alone); one
    profiled step and the host syncs of a step each. Every march call of
    one step held as made against the plain march on every
    GLASS_SUBSET-th lane (K1c bit-equal, K1d the march bar), timed whole
    and on the subset, with the subset's bound. The whole step with K1c
    against the same step with the plain march on a BUNNY_CROP crop of
    the frame (rtol 1e-5: the march is bit-equal; the albedo's 1e-4, its
    entries small differences of large sums); K1d's gradients against
    K1c's on the crop under BUNNY_MXU_SPREAD of K1c's own sample-to-sample
    difference there (norm over norm; on the whole frame printed beside K1c's
    spread)."""
    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[8f] TF32 matmuls are on: the backward's "
                             "matmuls must run in full f32")
    scene, env = bunny.glass_scene(dev), bunny.glass_environment(device=dev)
    base = bunny.glass_config().replace(max_raytrace=8)
    cam = bunny.camera(base.width / base.height, dev)
    out = {}
    for mxu in (False, True):
        cfg = base.replace(bunny_mxu=mxu)
        kind = "k1d" if mxu else "k1c"
        label = (f"8f bunny scan-AD, glass {cfg.width}x{cfg.height}, 8 "
                 f"bounces, {kind.upper()}")
        step = functools.partial(bunny_step, scene, env, cam, cfg)
        r = fwd_bwd(label, scene, env, cam, cfg, True, (kind,), grads=step)
        r["profile"] = pass_profile(f"[8f {kind.upper()}]",
                                    lambda: step(7), r["s"] * 1e3)
        r["syncs"] = host_syncs(lambda: step(7))
        _, calls = record_as_made(lambda: step(5))
        r["held"] = hold_as_made(f"8f {kind.upper()}", calls,
                                 time_calls=True)
        del calls
        log(f"[8f {kind.upper()}] host syncs a step: {r['syncs']}; "
            f"gradient max |g|: " + ", ".join(
                f"{k} {float(g.abs().max()):.4e}"
                for k, g in r["grads"].items()))
        out[mxu] = r
    # the whole frame: a sample's MLP gradient is a sum that a few bright,
    # steep-to-grazing lanes dominate, so K1d's (a surface a TF32 rounding
    # away) and another sample's differ from K1c's alike; printed
    spread = bunny_step(scene, env, cam, base, GRAD_STEPS - 1)
    k1c, k1d = out[False]["grads"], out[True]["grads"]
    log(f"[8f] the whole frame, |a - b| / |b| against K1c at sample "
        f"{GRAD_STEPS}: K1d " + ", ".join(
            f"{k} {rel_diff(k1d[k], k1c[k]):.3e}" for k in BUNNY_GRAD_FIELDS)
        + f"; K1c at sample {GRAD_STEPS - 1} " + ", ".join(
            f"{k} {rel_diff(spread[k], k1c[k]):.3e}"
            for k in BUNNY_GRAD_FIELDS))
    # the crop: the whole step with K1c against the plain march's, and
    # K1d's against K1c's within a share of K1c's sample-to-sample spread
    w, h = BUNNY_CROP
    x0, y0 = (base.width - w) // 2, (base.height - h) // 2
    xs = torch.arange(x0, x0 + w, device=dev)
    ys = torch.arange(y0, y0 + h, device=dev)
    crop = (xs[:, None] * base.height + ys[None, :]).reshape(-1)
    kernel = bunny_step(scene, env, cam, base, 3, crop)
    plain = with_march(lambda: bunny_step(scene, env, cam, base, 3, crop),
                       plain_march)
    same = []
    for k in BUNNY_GRAD_FIELDS:
        a, b = kernel[k], plain[k]
        # the albedo's gradient adds the crop's 32,400 lanes x 8 bounces,
        # and its entries are small differences of large sums
        rtol, floor = (1e-4, 1e-4) if k == "albedo" else (1e-5, 1e-6)
        torch.testing.assert_close(a, b, rtol=rtol,
                                   atol=floor * float(b.abs().max()))
        if torch.equal(a, b):
            same.append(k)
    log(f"[8f] the step on the {w}x{h} crop ({crop.numel()} pixels) with "
        f"K1c against the plain march: the MLP's and the matrix's "
        f"gradients within rtol 1e-5, the albedo's 1e-4; bit-identical: "
        f"{', '.join(same) or 'none'}; relative differences " + ", ".join(
            f"{k} {rel_diff(kernel[k], plain[k]):.3e}"
            for k in BUNNY_GRAD_FIELDS))
    k1d = bunny_step(scene, env, cam, base.replace(bunny_mxu=True), 3, crop)
    other = bunny_step(scene, env, cam, base, 4, crop)
    ratio = {k: rel_diff(k1d[k], kernel[k]) / rel_diff(other[k], kernel[k])
             for k in BUNNY_GRAD_FIELDS}
    worst = max(ratio.values())
    log(f"[8f] the crop, K1d's step against K1c's (sample 3) over K1c's at "
        f"sample 4 against sample 3: " + ", ".join(
            f"{k} {rel_diff(k1d[k], kernel[k]):.3e} / "
            f"{rel_diff(other[k], kernel[k]):.3e}" for k in BUNNY_GRAD_FIELDS)
        + f"; the largest ratio {worst:.4f}, bar {BUNNY_MXU_SPREAD}")
    if not worst <= BUNNY_MXU_SPREAD:
        raise AssertionError(f"[8f] K1d's gradients differ from K1c's by "
                             f"{worst:.4f} of K1c's sample spread, over "
                             f"{BUNNY_MXU_SPREAD}")
    out["mxu_worst"] = worst
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[8f] phase {out['seconds']:.1f} s; card {card_line()}")
    return out


def phase_bunny_train(dev):
    """8g: training the bunny's MLP with ``param_mask(set())`` (every
    object buffer frozen, the MLP trained, as JAX's step does), K1c. The
    recovery at BUNNY_RECOVERY_RES: the target the true scene rendered at
    BUNNY_TARGET_SPP from far sample ids; the start the same scene with
    the output bias shifted by BUNNY_BIAS_SHIFT (a uniform offset of the
    SDF); the absolute hit test at 1e-4; BUNNY_RECOVERY_STEPS steps of
    Adam under the cosine schedule from BUNNY_RECOVERY_LR at
    BUNNY_RECOVERY_SPP samples a step: the last ten losses average under
    1 / BUNNY_LOSS_DROP of the first, and the bias ends nearer its true
    value. Then 1 + TRAIN_TIMED_STEPS timed
    steps at 1920x1080 (8 bounces, spp 1), s/step and peak memory, the
    object buffers unchanged and the MLP moved; and every march call of
    the step after them, as made, held against the plain march on the
    scene as it stood (the pack-cache check: the kernel must march the
    updated MLP)."""
    t_phase = time.perf_counter()
    true = bunny.glass_scene(dev)
    start = true.replace(bunny=true.bunny._replace(
        bias_out=true.bunny.bias_out + BUNNY_BIAS_SHIFT))
    mask = ptrain.param_mask(set())
    env = bunny.glass_environment(device=dev)
    # the absolute hit test: at 64x36 the relative one stops a march up
    # to a pixel radius (1/36 of the distance) short of the surface, where
    # the implicit gradient is not the image's
    cfg = bunny.glass_config().replace(
        resolution=BUNNY_RECOVERY_RES, max_raytrace=8,
        hit_criterion=HitCriterion.ABSOLUTE, hit_precision=1e-4)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    target = ptrain.render_pixels(true, env, cam, pid, cfg,
                                  spp=BUNNY_TARGET_SPP, sample_offset=10_000,
                                  differentiable=False)
    step = ptrain.make_sharded_train_step(env, cam, cfg,
                                          spp=BUNNY_RECOVERY_SPP,
                                          param_filter=mask)
    ts = ptrain.make_train_state(start, ptrain.adam(
        ptrain.cosine_decay_schedule(BUNNY_RECOVERY_LR, BUNNY_RECOVERY_STEPS,
                                     alpha=0.05)))
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(BUNNY_RECOVERY_STEPS):
        ts, loss = step(ts, target)
        losses.append(float(loss))
    rec_s = time.perf_counter() - t0
    launches = dict(march_kernel.LAUNCHES)
    true_bias = float(true.bunny.bias_out)
    gap = abs(float(ts.scene.bunny.bias_out) - true_bias)
    drop = losses[0] / max(statistics.mean(losses[-10:]), 1e-30)
    log(f"[8g] MLP recovery {cfg.width}x{cfg.height}, "
        f"{BUNNY_RECOVERY_STEPS} steps of {BUNNY_RECOVERY_SPP} spp in "
        f"{rec_s:.2f} s: loss {losses[0]:.6e} -> "
        f"{statistics.mean(losses[-10:]):.6e} (last ten), {drop:.2f}x "
        f"(at least {BUNNY_LOSS_DROP}x required); |bias_out - true| "
        f"{BUNNY_BIAS_SHIFT} -> {gap:.6f}; K1c launches {launches['k1c']}; "
        f"losses {[round(v, 8) for v in losses]}")
    if not (drop >= BUNNY_LOSS_DROP and gap < BUNNY_BIAS_SHIFT
            and launches["k1c"] > 0
            and not any(v for k, v in launches.items() if k != "k1c")):
        raise AssertionError(f"[8g] the MLP was not recovered: loss drop "
                             f"{drop:.3f}x, bias gap {gap}, launches "
                             f"{launches}")

    env = bunny.glass_environment(device=dev)
    cfg = bunny.glass_config().replace(max_raytrace=8)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    target = ptrain.render_pixels(true, env, cam, pid, cfg, spp=1,
                                  sample_offset=10_000, differentiable=False)
    step = ptrain.make_sharded_train_step(env, cam, cfg, spp=1,
                                          param_filter=mask)
    ts = ptrain.make_train_state(start, ptrain.adam(1e-4))
    first = [v.clone() for v in scenelib.params(ts.scene)]
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
    moved = [k for k, a, b in zip(scenelib.param_names(ts.scene), first,
                                  scenelib.params(ts.scene))
             if not torch.equal(a, b)]
    if not (np.isfinite(loss) and launches["k1c"] > 0
            and not any(v for k, v in launches.items() if k != "k1c")
            and sorted(moved) == sorted("bunny_" + k
                                        for k in BunnyMLP._fields)):
        raise AssertionError(f"[8g] loss {loss}, launches {launches}, "
                             f"buffers moved {moved}")
    log(f"[8g] train step, glass {cfg.width}x{cfg.height}, 8 bounces, "
        f"param_mask(set()), dual buffer: {dt:.4f} s/step over "
        f"{TRAIN_TIMED_STEPS} steps ({cfg.num_pixels / dt / 1e6:.4f} "
        f"Msamples/s of the differentiated buffer), peak device memory "
        f"{mem:.3f} GiB above the {held / 2**30:.3f} held before, K1c "
        f"launches a step {launches['k1c'] / TRAIN_TIMED_STEPS:g}, loss "
        f"{loss:.6e}; the MLP's eight tensors moved, the object buffers "
        f"not; card {card_line()}")
    (ts, _), calls = record_as_made(lambda: step(ts, target))
    held_calls = hold_as_made("8g K1c, the step after the timed ones",
                              calls)
    del calls
    secs = time.perf_counter() - t_phase
    log(f"[8g] phase {secs:.1f} s")
    return dict(losses=losses, drop=drop, gap=gap, recovery_s=rec_s, s=dt,
                mem=mem, launches=launches["k1c"] / TRAIN_TIMED_STEPS,
                held=held_calls, seconds=secs)


def bunny_gradient_phases(dev):
    """8f, 8g. Returns what the summary and the kernels line read."""
    scan = phase_bunny_scan_ad(dev)
    train = phase_bunny_train(dev)
    log(f"[8f-8g] summary ({card_line()}): bunny scan-AD glass 1920x1080, "
        f"8 bounces: K1c {scan[False]['s']:.4f} s/step, "
        f"{scan[False]['mem']:.3f} GiB; K1d {scan[True]['s']:.4f} s/step, "
        f"{scan[True]['mem']:.3f} GiB; K1d vs K1c on the crop "
        f"{scan['mxu_worst']:.4f} of K1c's spread; "
        f"train step {train['s']:.4f} s/step, {train['mem']:.3f} GiB; "
        f"recovery loss drop {train['drop']:.2f}x; 8f {scan['seconds']:.1f} "
        f"s, 8g {train['seconds']:.1f} s")
    return dict(scan=scan, train=train)


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


# --- compaction and reprojection ---------------------------------------------


def to_cpu(x):
    """A FrameState or Camera (a dataclass of tensors, rays nested) on the
    CPU."""
    return type(x)(**{k: to_cpu(v) if dataclasses.is_dataclass(v)
                      else v.cpu() for k, v in vars(x).items()})


def adaptive_frames(scene, env, cam, cfg, compact):
    """ADAPTIVE_FRAMES wavefront frames from a fresh state over the lane ->
    pixel map, repacked actives-first every ADAPTIVE_EVERY frames when
    ``compact``. Returns the last pixels and the map they were rendered
    over, the last state and its map, each frame's ms (CUDA events, the
    frame alone), the share of pixels gated off for the next frame, and
    each compaction's ms and lanes moved."""
    state = make_frame_state(cfg.num_pixels, device=scene.device)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=scene.device)
    times, inactive, packs = [], [], []
    march_kernel.reset_launches()
    for f in range(1, ADAPTIVE_FRAMES + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        px, state = integrator.render_frame_tile(scene, env, cam, state, cfg,
                                                 pid)
        px_pid = pid
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        inactive.append(float((state.noise <= cfg.noise_threshold)
                              .float().mean()))
        if compact and f % ADAPTIVE_EVERY == 0:
            start.record()
            state, new = compactlib.compact_frame_state(state, pid,
                                                        cfg.noise_threshold)
            end.record()
            end.synchronize()
            packs.append((start.elapsed_time(end), int((new != pid).sum())))
            pid = new
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    launches = dict(march_kernel.LAUNCHES)
    if launches != {"k1a": steps * ADAPTIVE_FRAMES, "k1b": 0, "k1c": 0,
                    "k1d": 0}:
        raise AssertionError(f"[9c] launches {launches}")
    return ((px, px_pid), state, pid, times, inactive, packs,
            launches["k1a"])


def same_bits(a, b) -> bool:
    """Bit-identical tensors or arrays: equal bit patterns, so a NaN equals
    a NaN of the same payload and -0.0 differs from 0.0."""
    a = torch.as_tensor(a).cpu().contiguous()
    b = torch.as_tensor(b).cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (v.view(view[v.element_size()]) for v in (a, b))
    return torch.equal(a, b)


def phase_adaptive_compaction(dev):
    """9c: the Cornell main path at 480x480 with adaptive sampling
    (noise threshold ADAPTIVE_THRESHOLD), ADAPTIVE_FRAMES frames compacted
    every ADAPTIVE_EVERY frames against as many uncompacted, in turns off,
    on, on, off. The compacted run's raster and uncompacted state equal
    the other's bit for bit; a compaction moved lanes, and at least 10% of
    the pixels were gated off at the last one."""
    cfg = bench.headline_config().replace(adaptive_sampling=True,
                                noise_threshold=ADAPTIVE_THRESHOLD)
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    # warm-up: the adaptive gate's first frames
    st = make_frame_state(cfg.num_pixels, device=dev)
    for _ in range(2):
        _, st = render_frame(scene, env, cam, st, cfg)
    torch.cuda.synchronize()
    del st
    runs = {False: [], True: []}
    for comp in (False, True, True, False):
        runs[comp].append(adaptive_frames(scene, env, cam, cfg, comp))
    (px_a, _), st_a, _, t_a, inact, _, _ = runs[False][0]
    (px_b, px_pid), st_b, pid_b, t_b, inact_b, packs, _ = runs[True][0]
    # the pixels in raster order through the map they were rendered over
    raster = compactlib.scatter_pixels(px_b, px_pid, cfg)
    back = compactlib.uncompact_frame_state(st_b, pid_b)
    bad = [k for k in ("accum", "pixels", "noise", "diff_accum", "respawn",
                       "hit_t", "march_state", "march_cum", "sky_w")
           if not same_bits(getattr(back, k), getattr(st_a, k))]
    if not same_bits(back.rays.color, st_a.rays.color):
        bad.append("rays.color")
    if not same_bits(raster, px_a.cpu().numpy()):
        bad.append("the raster")
    if bad:
        raise AssertionError(f"[9c] the compacted run differs in {bad}")
    if inact != inact_b:
        raise AssertionError("[9c] the inactive shares differ")
    last = ADAPTIVE_FRAMES - ADAPTIVE_FRAMES % ADAPTIVE_EVERY - 1
    if not (any(m for _, m in packs) and inact[last] >= 0.10):
        raise AssertionError(f"[9c] compaction moved {packs} lanes with "
                             f"{inact[last]:.3f} of pixels inactive")
    first = min(k for k, (_, m) in enumerate(packs) if m)
    after = (first + 1) * ADAPTIVE_EVERY  # frames from here run compacted
    mean = lambda comp, sl: statistics.mean(
        statistics.mean(r[3][sl]) for r in runs[comp])
    out = dict(ms_off=mean(False, slice(None)), ms_on=mean(True, slice(None)),
               ms_off_after=mean(False, slice(after, None)),
               ms_on_after=mean(True, slice(after, None)),
               pack_ms=statistics.mean(ms for r in runs[True]
                                       for ms, _ in r[5]),
               inactive=inact, moved=[m for _, m in packs], after=after,
               launches_per_frame={
                   "compacted" if comp else "uncompacted":
                       statistics.mean(r[6] for r in runs[comp])
                       / ADAPTIVE_FRAMES for comp in (False, True)})
    log(f"[9c] adaptive Cornell 480x480 ({card_line()}), "
        f"{ADAPTIVE_FRAMES} frames, noise threshold {ADAPTIVE_THRESHOLD}, "
        f"compacted every {ADAPTIVE_EVERY}: raster and state bit-identical "
        f"to the uncompacted run; inactive share after each frame "
        f"{', '.join(f'{v:.3f}' for v in inact)}; lanes moved by each "
        f"compaction {out['moved']}, {out['pack_ms']:.3f} ms each; ms/frame "
        f"uncompacted {out['ms_off']:.3f}, compacted {out['ms_on']:.3f} "
        f"(frames {after + 1}-{ADAPTIVE_FRAMES}, after the first compaction "
        f"that moved lanes: {out['ms_off_after']:.3f} / "
        f"{out['ms_on_after']:.3f}; means of two runs each, in turns); "
        f"K1a launches a frame {out['launches_per_frame']}; frame ms "
        f"compacted {', '.join(f'{v:.2f}' for v in t_b)}; uncompacted "
        f"{', '.join(f'{v:.2f}' for v in t_a)}")
    return out


def phase_reprojection(dev):
    """9d: the interactive app's session on the engine scene at 768x432
    (``apps.interactive``) through REPROJECT_SCRIPT with ``--reproject``
    and without: ms a frame, the frames that reprojected; ``reproject``'s
    own ms (CUDA events) on the session's state; the card's ``reproject``
    against the CPU's on the same state; and
    ``tests/test_reproject.py::test_render_frame_reprojection_beats_zero_reset``'s
    property at full width."""
    out = {}
    count = {"n": 0}
    real = reprojectlib.reproject

    def counted(*a, **k):
        count["n"] += 1
        return real(*a, **k)
    shots = os.path.join(REPO, "build", "interactive_smoke")
    for rp in (False, True, True, False):
        sess = interactive.session_setup(1, reproject=rp, device=dev,
                                         out_dir=shots)
        sess.step()
        torch.cuda.synchronize()
        march_kernel.reset_launches()
        count["n"] = 0
        reprojectlib.reproject = counted
        try:
            t0 = time.perf_counter()
            sess.run_commands(REPROJECT_SCRIPT)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / len(REPROJECT_SCRIPT) * 1e3
        finally:
            reprojectlib.reproject = real
        launches = dict(march_kernel.LAUNCHES)
        steps = sess.cfg.samples_per_frame * sess.cfg.samples_per_pixel
        if launches != {"k1a": 0, "k1b": steps * len(REPROJECT_SCRIPT),
                        "k1c": 0, "k1d": 0}:
            raise AssertionError(f"[9d] launches {launches}")
        if bool(count["n"]) != rp:
            raise AssertionError(f"[9d] {count['n']} reprojections with "
                                 f"--reproject {rp}")
        if not bool(torch.isfinite(sess.pixels).all()):
            raise AssertionError("[9d] the frame is not finite")
        out.setdefault(rp, []).append(dict(ms=ms, reprojected=count["n"],
                                           launches=launches["k1b"]))
        log(f"[9d] interactive engine 768x432 --reproject {rp}: "
            f"{len(REPROJECT_SCRIPT)} commands {REPROJECT_SCRIPT}, "
            f"{ms:.3f} ms a frame, {count['n']} frames reprojected, "
            f"{launches['k1b']} K1b launches")
    cfg, state = sess.cfg.replace(reprojection=True), sess.state
    cam = sess._camera()
    moved = make_camera(lookfrom=(0.05, -0.15, 3.9), lookat=(0.0, -0.2, 3.0),
                        vfov=sess.vfov, aspect=cfg.width / cfg.height,
                        device=dev)
    rp_ms = median_ms(lambda: reprojectlib.reproject(state, cam, moved, cfg),
                      10)
    got = reprojectlib.reproject(state, cam, moved, cfg)
    ref = reprojectlib.reproject(to_cpu(state), to_cpu(cam), to_cpu(moved),
                                 cfg)
    close = lambda a, b: torch.isclose(a.cpu(), b, rtol=1e-5, atol=1e-6)
    acc_ok = close(got.accum, ref.accum).all(dim=1)
    acc_bits = float((got.accum.cpu() == ref.accum).all(dim=1)
                     .float().mean())
    t_bits = float((got.hit_t.cpu() == ref.hit_t).float().mean())
    # the depths: an amin scatter, exact in any order, of distances both
    # devices compute alike (ops/reproject)
    if float(acc_ok.float().mean()) < 0.999 or t_bits < 1.0:
        raise AssertionError(f"[9d] reproject on the card vs the CPU: "
                             f"{float(acc_ok.float().mean()):.5f} of "
                             f"pixels close in accum, hit_t bit-equal on "
                             f"{t_bits:.5f}")
    err = float((got.accum.cpu() - ref.accum).abs().max())
    # the property at full width, after a small move: one frame on the
    # warped history against one from zero, each against 40 frames of the
    # new view. On the test's own scene (the minimal Cornell box, 512x512)
    # in the mean radiance error, as the test judges it. On the app's
    # engine frames (768x432, the HDR sky) in what the app shows, the
    # tonemapped image, and in the median pixel's radiance error: there the
    # mean radiance error is decided by HDR values, and the warp's splat
    # (no depth test) carries bright history onto dim pixels, so it orders
    # the two the other way, in the JAX package as in the port
    # (tests/test_torch_reproject.py::test_engine_reprojection_errors_match_jax);
    # it is printed beside, with the share of each error on pixels whose
    # estimate is over ten times max(target, 1)
    mcfg = cornell.minimal_config().replace(max_raytrace=8,
                                            reprojection=True)
    mcam = cornell.minimal_camera(dev)
    props = {
        "Cornell minimal 512x512": (
            cornell.minimal_scene(dev), cornell.sky(dev), mcfg, mcam,
            make_camera(lookfrom=(0.01, 0.0, 3.5), lookat=(0.01, 0.0, -1.0),
                        vfov=35.0, aspect=1.0, aperture=0.0, focus=1.0,
                        device=dev), False),
        "engine 768x432": (
            sess.scene, sess.env, cfg, demo.engine_camera(dev),
            make_camera(lookfrom=(0.02, -0.2, 4.0), lookat=(0.02, -0.2, 3.0),
                        aspect=cfg.width / cfg.height, device=dev), True)}
    errs = {}
    for label, (scene, env, pcfg, cam0, cam2, shown) in props.items():
        def frames(c, n, st=None):
            st = st if st is not None else make_frame_state(
                pcfg.num_pixels, device=dev)
            for _ in range(n):
                _, st = render_frame(scene, env, c, st, pcfg)
            return st

        def mean_of(st):
            return st.accum[:, :3] / torch.clamp_min(st.accum[:, 3:4], 1.0)
        target = mean_of(frames(cam2, 40))
        hist = frames(cam0, 30)
        _, with_rp = render_frame(scene, env, cam2, hist, pcfg,
                                  refreshing=True, prev_cam=cam0)
        _, from_zero = render_frame(scene, env, cam2, hist,
                                    pcfg.replace(reprojection=False),
                                    refreshing=True)
        e = reprojection_errors(target, mean_of(with_rp), mean_of(from_zero),
                                lambda x: postlib.tonemap(x, pcfg))
        judged = ("tonemapped", "median") if shown else ("radiance",)
        if not all(e[k][0] < e[k][1] for k in judged):
            raise AssertionError(f"[9d] {label}: reprojection's error is "
                                 f"not below the zero reset's in {judged}: "
                                 f"{e}")
        errs[label] = dict(e, judged=judged)
    out.update(reproject_ms=rp_ms, accum_bits=acc_bits, hit_t_bits=t_bits,
               accum_err=err, property=errs)
    mean = lambda rp: statistics.mean(v["ms"] for v in out[rp])
    log(f"[9d] ({card_line()}) ms a frame: --reproject {mean(True):.3f}, "
        f"without {mean(False):.3f} (means of two runs, in turns); "
        f"reproject at {cfg.num_pixels} pixels {rp_ms:.4f} ms (median of "
        f"10, CUDA events); against the CPU on the same state: accum within "
        f"rtol 1e-5 on {float(acc_ok.float().mean()):.5f} of pixels, "
        f"bit-equal on {acc_bits:.5f} (max |diff| {err:.3e}: the card's "
        f"atomic adds reorder a pixel's sums), hit_t bit-equal on "
        f"{t_bits:.5f}; after a small move, one frame's mean abs error "
        f"against 40 frames of the new view, reprojected against from zero: "
        + "; ".join(f"{k} (judged in {' and '.join(v['judged'])}): "
                    + ", ".join(f"{m} {v[m][0]:.5f} / {v[m][1]:.5f}"
                                for m in ("radiance", "median", "tonemapped",
                                          "bright_share"))
                    for k, v in errs.items()))
    return out


def reprojection_errors(target, with_rp, from_zero, tonemap):
    """9d: one frame's error against the converged new view, reprojected
    and from zero ((N, 3) radiance each), as [reprojected, from zero]: the
    mean (``radiance``) and the median of the per-pixel mean absolute
    radiance error, the tonemapped image's mean absolute error, and the
    share of the radiance error on pixels whose estimate is over ten times
    ``max(target, 1)`` (``bright_share``: HDR history on a dim pixel);
    tests/test_torch_reproject.py defines the same on the CPU."""
    out = {k: [] for k in ("radiance", "median", "tonemapped",
                           "bright_share")}
    tm_target = tonemap(target)
    for est in (with_rp, from_zero):
        e = (est - target).abs().mean(dim=1)
        bright = est.amax(dim=1) > 10 * torch.clamp_min(target.amax(dim=1),
                                                        1.0)
        out["radiance"].append(float(e.mean()))
        # numpy's median (the mean of the middle two), as the test's
        out["median"].append(float(np.median(e.cpu().numpy())))
        out["tonemapped"].append(float((tonemap(est) - tm_target).abs()
                                       .mean()))
        out["bright_share"].append(float(e[bright].sum() / e.sum()))
    return out


def phase_preview_app(dev):
    """9e: ``progressive.run`` as ``--scene cornell --adaptive
    --compact-every 4 --serve 0`` calls it, with the noise threshold at
    ADAPTIVE_THRESHOLD (the config's gates no pixel off in a short run),
    in a subprocess on the card for SERVE_MINUTES: /frame.png
    and /stats fetched over localhost while it runs; rc 0; a compaction
    moved lanes (the metrics' ``lanes_moved``); the saved ``final.png``
    equal to the raster of the saved checkpoint's pixels."""
    import urllib.error
    import urllib.request
    out = os.path.join(REPO, "build", "preview_smoke")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    metrics = os.path.join(out, "metrics.jsonl")
    cmd = [sys.executable, "-c", (
        "import sys\n"
        "from raytracingpbr_tpu_torch.apps import progressive as p\n"
        "scene, env, cam, cfg, exposure = p.scene_setup('cornell', "
        "adaptive=True)\n"
        f"p.run(scene, env, cam, cfg.replace(noise_threshold="
        f"{ADAPTIVE_THRESHOLD}), sys.argv[1], minutes={SERVE_MINUTES}, "
        f"exposure=exposure, metrics_path=sys.argv[2], serve=0, "
        f"compact_every={ADAPTIVE_EVERY})\n"), out, metrics]
    t0 = time.perf_counter()
    with open(os.path.join(out, "stderr.txt"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        try:
            url = None
            for line in proc.stdout:
                if line.startswith("preview: "):
                    url = line.split()[1].rstrip("/")
                    break
            if url is None:
                raise AssertionError("[9e] the app printed no preview URL")
            png = None
            deadline = time.time() + 300
            while png is None and time.time() < deadline:
                try:
                    png = urllib.request.urlopen(url + "/frame.png",
                                                 timeout=10).read()
                except urllib.error.HTTPError as e:  # 503: no frame yet
                    if e.code != 503:
                        raise
                    time.sleep(0.2)
            stats = json.loads(urllib.request.urlopen(url + "/stats",
                                                      timeout=10).read())
            rest, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(os.path.join(out, "stderr.txt")) as f:
            raise AssertionError(f"[9e] rc {proc.returncode}: "
                                 f"{f.read()[-4000:]}")
    if png is None or not png.startswith(b"\x89PNG"):
        raise AssertionError("[9e] /frame.png served no PNG")
    with open(metrics) as f:
        rec = [json.loads(line) for line in f]
    moved = [r["lanes_moved"] for r in rec if "lanes_moved" in r]
    if not any(moved):
        raise AssertionError(f"[9e] no compaction moved a lane: {moved}")
    st, meta = ckpt.load(os.path.join(out, "state.npz"), device="cpu")
    raster = st.pixels.numpy().reshape(480, 480, 3).transpose(1, 0, 2)[::-1]
    saved = read_png(os.path.join(out, "final.png"))
    if not np.array_equal(saved, imageio._to_u8(raster)):
        raise AssertionError("[9e] final.png is not the raster of the "
                             "checkpoint's pixels")
    log(f"[9e] progressive.run, --scene cornell --adaptive --compact-every "
        f"{ADAPTIVE_EVERY} --serve 0 --minutes {SERVE_MINUTES} at noise "
        f"threshold {ADAPTIVE_THRESHOLD}: rc 0 in {secs:.1f} s, "
        f"{meta['frame']} frames; fetched /frame.png ({len(png)} bytes) and "
        f"/stats (frame "
        f"{stats.get('frame')}, mean spp {stats.get('mean_spp', 0):.2f}) "
        f"from {url} while it ran; compactions moved "
        f"{moved[:3]}...{moved[-2:]} lanes ({len(moved)} compactions); "
        f"final.png equals the raster of the checkpoint's pixels; last "
        f"frame {rec[-1]['dt'] * 1e3:.1f} ms")
    return dict(frames=meta["frame"], moved=moved, last_ms=rec[-1]["dt"])


def compaction_phases(dev):
    """9c-9e. Returns what the kernels line reads."""
    t0 = time.perf_counter()
    adaptive = phase_adaptive_compaction(dev)
    reproj = phase_reprojection(dev)
    app = phase_preview_app(dev)
    log(f"[9] compaction and reprojection phases: "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(adaptive=adaptive, reproj=reproj, app=app)


# --- distributed: the mesh, sharded stills and frames, the train step -------

def timed_s(fn):
    """Seconds of fn() on the host clock between two syncs, and its
    result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def launches_of(fn):
    """fn()'s result and the march kernels' launches it made."""
    march_kernel.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(march_kernel.LAUNCHES)


def phase_sharded_stills(dev):
    """10a: ``render_image_sharded`` on the Cornell full box at 480x480,
    spp SHARDED_SPP, on each of SHARDED_MESHES in one process, against
    ``render_image``: tiles-only meshes bit-identical, sample meshes within
    atol 1e-5 / rtol 1e-4; K1a the only march kernel. Then ms a pass (a
    sample of every pixel) of each, every render timed twice in turns
    (unsharded, the meshes, the meshes backwards, unsharded). On each mesh
    with sample ranks, every K1a call of one render at spp = its sample
    ranks (a sample a rank; 460,800 lanes on (4,2), 921,600 on (2,4)) is
    recorded and held bit-equal to the plain march."""
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    cfg = cornell.full_config()
    runs = {"unsharded": lambda: render_image(
        scene, env, cam, cfg, spp=SHARDED_SPP, tonemapped=False)}
    for tiles, samples, layout in SHARDED_MESHES:
        runs[f"({tiles},{samples}) {layout}"] = functools.partial(
            prender.render_image_sharded, scene, env, cam, cfg,
            pmesh.make_mesh(tiles, samples), spp=SHARDED_SPP,
            tonemapped=False, layout=layout)
    out, ref = {}, None
    for label, run in runs.items():
        img, launches = launches_of(run)
        if any(v for k, v in launches.items() if k != "k1a") or not \
                launches["k1a"]:
            raise AssertionError(f"[10a] {label}: launches {launches}")
        out[label] = dict(k1a_per_pass=launches["k1a"] / SHARDED_SPP)
        if ref is None:
            ref = img
            continue
        same = same_bits(img, ref)
        err = float((img - ref).abs().max())
        if "1)" in label and not same:
            raise AssertionError(f"[10a] {label}: not bit-identical to "
                                 f"render_image (max |diff| {err})")
        if not torch.allclose(img, ref, atol=1e-5, rtol=1e-4):
            raise AssertionError(f"[10a] {label}: max |diff| {err}")
        out[label].update(bit_identical=same, max_abs_diff=err)
    for tiles, samples, layout in SHARDED_MESHES:
        if samples == 1:
            continue
        label = f"({tiles},{samples}) {layout}"
        calls = record_step(lambda: prender.render_image_sharded(
            scene, env, cam, cfg, pmesh.make_mesh(tiles, samples),
            spp=samples, tonemapped=False, layout=layout))
        held = hold_calls(f"10a {label}", calls, f"render at spp {samples}")
        if set(held) != {"k1a"}:
            raise AssertionError(f"[10a] {label}: calls {held}")
        out[label].update(held_calls=held["k1a"][0], held_spp=samples,
                          lanes_per_call=calls[0][1][0].shape[0])
    times = {label: [] for label in runs}
    for label in list(runs) + list(runs)[::-1]:
        times[label].append(timed_s(runs[label])[0])
    for label, v in out.items():
        v["ms_per_pass"] = statistics.mean(times[label]) / SHARDED_SPP * 1e3
        v["ms_per_pass_runs"] = [t / SHARDED_SPP * 1e3 for t in times[label]]
        check = ("" if label == "unsharded" else
                 "; bit-identical to render_image" if v["bit_identical"]
                 else f"; within atol 1e-5 / rtol 1e-4 (max |diff| "
                      f"{v['max_abs_diff']:.3e})")
        if "held_calls" in v:
            check += (f"; the {v['held_calls']} K1a calls of a render at "
                      f"spp {v['held_spp']} ({v['lanes_per_call']} lanes "
                      f"each) bit-equal to the plain march")
        log(f"[10a] Cornell full 480x480, spp {SHARDED_SPP}, {label}: "
            f"{v['ms_per_pass']:.3f} ms a pass (runs "
            f"{', '.join(f'{t:.3f}' for t in v['ms_per_pass_runs'])}; "
            f"unsharded {out['unsharded']['ms_per_pass']:.3f}){check}; K1a "
            f"{v['k1a_per_pass']:g} launches a pass")
    return out


def frames_each_way(scene, env, cam, cfg, mesh, layout, count):
    """``count`` frames from fresh states through ``render_frame`` and
    through ``render_frame_sharded`` on ``mesh``, in turns (a frame of
    each, which goes first alternating), each frame timed alone between
    syncs. Returns the unsharded and the sharded (pixels, state), the mean
    ms a frame of each over frames 2 on, and the sharded run's launches
    a frame."""
    step = {False: lambda st: render_frame(scene, env, cam, st, cfg),
            True: lambda st: prender.render_frame_sharded(
                scene, env, cam, st, cfg, mesh, layout=layout)}
    fresh = make_frame_state(cfg.num_pixels, device=scene.device)
    res = {False: (None, fresh),
           True: (None, prender.shard_frame_state(fresh, mesh, layout))}
    ms = {False: [], True: []}
    per = dict.fromkeys(march_kernel.LAUNCHES, 0)
    for f in range(count):
        for sharded in ((False, True) if f % 2 == 0 else (True, False)):
            march_kernel.reset_launches()
            secs, res[sharded] = timed_s(lambda: step[sharded](
                res[sharded][1]))
            if sharded:
                for k, v in march_kernel.LAUNCHES.items():
                    per[k] += v / count
            if f:
                ms[sharded].append(secs * 1e3)
    return [(res[k], statistics.mean(ms[k]), per) for k in (False, True)]


def phase_sharded_frames(dev):
    """10b: the Cornell main path (480x480, 4 steps a frame) for
    SHARDED_FRAMES frames through ``render_frame_sharded`` on (8, 1)
    contiguous and strided: pixels and accumulator bit-identical to
    ``render_frame``'s; the engine at 768x432 with ``cfg.reprojection`` on
    (8, 1) strided: 3 frames, a 0.08 move, a reprojected refresh, held to
    PR 9's bar (rtol 1e-5 on at least 99.9% of pixels); the adaptive gate
    at ADAPTIVE_THRESHOLD over SHARDED_ADAPTIVE_FRAMES frames (strided):
    the set of stopped pixels equal."""
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    cfg = bench.headline_config()
    mesh = pmesh.make_mesh(8, 1)
    out = {}
    for layout in ("contiguous", "strided"):
        (a, ms_a, _), (b, ms_b, per) = frames_each_way(
            scene, env, cam, cfg, mesh, layout, SHARDED_FRAMES)
        un = lambda x: prender.unshard_pixels(x, 8, layout)
        if not (same_bits(un(b[0]), a[0])
                and same_bits(un(b[1].accum), a[1].accum)):
            raise AssertionError(f"[10b] (8,1) {layout}: the frames differ "
                                 "from render_frame")
        if per["k1a"] != 4 or sum(per.values()) != 4:
            raise AssertionError(f"[10b] launches a frame {per}")
        out[f"cornell (8,1) {layout}"] = dict(ms=ms_b, ms_unsharded=ms_a,
                                              k1a_per_frame=per["k1a"])
        log(f"[10b] Cornell 480x480 (8,1) {layout}, {SHARDED_FRAMES} frames:"
            f" pixels and accumulator bit-identical to render_frame; "
            f"{ms_b:.3f} ms/frame sharded, {ms_a:.3f} unsharded; K1a "
            f"{per['k1a']:g} a frame")

    escene, eenv, ecam, ecfg = k1b_paths(dev)["engine 768x432"]
    ecfg = ecfg.replace(reprojection=True)
    moved = dataclasses.replace(ecam, lookfrom=ecam.lookfrom + torch.tensor(
        [0.08, 0.0, 0.0], device=dev))
    (a, _, _), (b, _, per) = frames_each_way(escene, eenv, ecam, ecfg, mesh,
                                             "strided", 3)
    _, st_a = render_frame(escene, eenv, moved, a[1], ecfg, refreshing=True,
                           prev_cam=ecam)
    (_, st_b), launches = launches_of(lambda: prender.render_frame_sharded(
        escene, eenv, moved, b[1], ecfg, mesh, refreshing=True,
        prev_cam=ecam, layout="strided"))
    acc = prender.unshard_pixels(st_b.accum, 8, "strided")
    ok = float(torch.isclose(acc, st_a.accum, rtol=1e-5, atol=1e-6)
               .all(dim=1).float().mean())
    equal = float((acc == st_a.accum).all(dim=1).float().mean())
    if ok < 0.999 or launches["k1b"] != 4 or sum(launches.values()) != 4:
        raise AssertionError(f"[10b] engine reprojection: {ok:.5f} of pixels"
                             f" within rtol 1e-5, launches {launches}")
    out["engine (8,1) strided, reprojected"] = dict(
        close=ok, bit_equal=equal, k1b_per_frame=launches["k1b"])
    log(f"[10b] engine 768x432 (8,1) strided, reprojection: 3 frames, a "
        f"0.08 move, a reprojected refresh: the accumulator within rtol "
        f"1e-5 on {ok:.5f} of pixels, bit-equal on {equal:.5f}; K1b "
        f"{launches['k1b']} launches a frame, {per['k1b']:g} before")

    acfg = cfg.replace(adaptive_sampling=True,
                       noise_threshold=ADAPTIVE_THRESHOLD)
    (a, _, _), (b, _, _) = frames_each_way(scene, env, cam, acfg, mesh,
                                           "strided",
                                           SHARDED_ADAPTIVE_FRAMES)
    stop_a = a[1].noise <= ADAPTIVE_THRESHOLD
    stop_b = prender.unshard_pixels(b[1].noise, 8,
                                    "strided") <= ADAPTIVE_THRESHOLD
    if not (bool(stop_a.any()) and torch.equal(stop_a, stop_b)):
        raise AssertionError("[10b] the adaptive gate stopped other pixels")
    share = float(stop_a.float().mean())
    out["adaptive (8,1) strided"] = dict(stopped=share)
    log(f"[10b] adaptive gate at {ADAPTIVE_THRESHOLD}, "
        f"{SHARDED_ADAPTIVE_FRAMES} frames (8,1) strided: the same "
        f"{share:.4f} of pixels stopped")
    return out


def phase_sharded_processes(dev):
    """10c: ``apps.multihost`` in a subprocess, two processes sharing the
    card over gloo, each with 4 ranks of the (8, 1) mesh: Cornell full at
    480x480, spp 2, bit-identical to the one-process render; 3 train steps
    on (4, 2) within rtol 1e-5 of the one-process mesh. Then a
    one-process NCCL group through the same calls (``multihost.work``),
    against the group-less mesh."""
    full = cornell.full_config()
    cmd = [sys.executable, "-m", "raytracingpbr_tpu_torch.apps.multihost",
           "--device", "cuda", "--backend", "gloo", "--scene",
           "cornell_full", "--resolution", "480", "--max-raymarch",
           str(full.max_raymarch), "--max-raytrace", str(full.max_raytrace),
           "--mesh", "8x1", "--train-steps", "3"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO))
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[10c]   {line}")
    if proc.returncode != 0 or "MULTIHOST OK" not in proc.stdout:
        raise AssertionError(f"[10c] multihost rc {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    log(f"[10c] two processes on one card over gloo: {secs:.1f} s "
        f"(start-up, the kernels loaded, the one-process reference)")

    import torch.distributed as dist
    scene, env, cam, cfg = multihost.setup(
        "cornell_full", 480, full.max_raymarch, full.max_raytrace, dev)
    args = (scene, env, cam, cfg)
    store = tempfile.mkdtemp(prefix="rt_nccl_", dir=os.path.join(REPO,
                                                                 "build"))
    res = {}
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        for group in (dist.group.WORLD, None):
            t0 = time.perf_counter()
            (out, launches) = launches_of(lambda: multihost.work(
                *args, pmesh.make_mesh(8, 1, group=group), 2,
                pmesh.make_mesh(4, 2, group=group), 3))
            res[group is None] = (out, launches, time.perf_counter() - t0)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    (nc, launches, nsecs), (ref, _, rsecs) = res[False], res[True]
    same = np.array_equal(nc["albedo"], ref["albedo"])
    if not (backend == "nccl" and np.array_equal(nc["image"], ref["image"])
            and np.array_equal(nc["losses"], ref["losses"])
            and np.allclose(nc["albedo"], ref["albedo"], rtol=1e-5, atol=0)
            and launches["k1a"]):
        raise AssertionError(f"[10c] the NCCL world of one differs: "
                             f"{nc['losses']} vs {ref['losses']}")
    log(f"[10c] one-process NCCL world ({backend}): the (8,1) still and 3 "
        f"(4,2) train steps through its all_gather equal the group-less "
        f"mesh's (image bit-identical, losses {nc['losses'].tolist()} "
        f"bit-identical, albedo within rtol 1e-5, "
        f"{'bit-identical' if same else 'not bit-identical'}"
        f"); {nsecs:.2f} s against {rsecs:.2f} s; K1a {launches['k1a']}")
    return dict(gloo_s=secs, nccl_s=nsecs, ref_s=rsecs,
                nccl_k1a=launches["k1a"])


def phase_scaling(dev):
    """10d: ``parallel/scaling.measure`` on (8, 1) contiguous and strided,
    the Cornell main path at 480x480: the per-tile table, the time
    imbalance and the march-trip imbalance of each layout."""
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    out = {}
    for layout in ("contiguous", "strided"):
        rep = pscaling.measure(scene, env, cam, bench.headline_config(),
                               pmesh.make_mesh(8, 1), iters=SCALING_ITERS,
                               layout=layout)
        trips = np.array([t.march_iters for t in rep.tiles], float)
        trip_imb = float((trips.max() - trips.mean()) / trips.mean() * 100)
        out[layout] = dict(imbalance_pct=rep.imbalance_pct,
                           trip_imbalance_pct=trip_imb,
                           t_single=rep.t_single, t_sharded=rep.t_sharded,
                           virtual=rep.virtual)
        log(f"[10d] scaling, (8,1) {layout}:")
        for line in rep.table().splitlines():
            log(f"[10d]   {line}")
    log(f"[10d] imbalance (time) contiguous "
        f"{out['contiguous']['imbalance_pct']:.1f}% -> strided "
        f"{out['strided']['imbalance_pct']:.1f}%; (longest primary march) "
        f"{out['contiguous']['trip_imbalance_pct']:.1f}% -> "
        f"{out['strided']['trip_imbalance_pct']:.1f}%; the JAX package "
        f"records ~35% -> ~2% on its own device (a TPU/CPU figure, not a "
        f"target)")
    return out


def written_out_step(ts, env, cam, cfg, target, param_filter):
    """The one-card train step written out, as ``tests/test_torch_train.py``
    writes it: every pixel, sample ids from ``step * 2`` (spp 1), the
    dual-buffer surrogate's scan-AD gradient, the filter, Adam. Returns
    (state, loss)."""
    scene = ts.scene
    leaves = [v.detach().requires_grad_(True)
              for v in scenelib.params(scene)]
    sc = scenelib.with_params(scene, leaves)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                       device=scene.device)
    base = ts.step * 2
    img_b = ptrain.render_pixels(sc, env, cam, pid, cfg, spp=1,
                                 sample_offset=base)
    with torch.no_grad():
        img_a = ptrain.render_pixels(scene, env, cam, pid, cfg, spp=1,
                                     sample_offset=base + 1,
                                     differentiable=False)
    resid = img_a - target
    loss = torch.mean(resid * (img_b.detach() - target))
    grads = torch.autograd.grad(torch.mean(2.0 * resid * img_b), leaves,
                                allow_unused=True)
    g = param_filter(scenelib.with_params(scene, [
        torch.zeros_like(v) if d is None else d
        for v, d in zip(leaves, grads)]))
    opt, _ = ts.opt_state
    for v, d in zip(scenelib.params(scene), scenelib.params(g)):
        v.grad = d
    opt.step()
    opt.zero_grad(set_to_none=True)
    return ptrain.TrainState(scene, ts.opt_state, ts.step + 1), loss


def phase_mesh_train(dev, train_8e):
    """10e: the train step on the (4, 2) mesh at full width (Cornell full
    480x480, 8 bounces, albedo only, dual buffer, Adam at 0.01 toward a
    render of the true scene): 1 + MESH_TRAIN_STEPS timed steps, s/step
    next to 8e's one-card step; then every K1a call of one more step
    (460,800 lanes) recorded and held bit-equal to the plain march. Then
    one step of 8e's kind (materials only) on a 1 x 1 mesh and with
    ``mesh`` None, each against the step written out
    (:func:`written_out_step`) from the same start: the loss
    bit-identical, the scene within rtol 1e-5."""
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    cfg = grad_config(8)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    target = ptrain.render_pixels(scene, env, cam, pid, cfg, spp=1,
                                  sample_offset=10_000,
                                  differentiable=False)
    start = scene.replace(albedo=scene.albedo * 0.8)
    step = ptrain.make_sharded_train_step(
        env, cam, cfg, pmesh.make_mesh(4, 2), spp=1,
        param_filter=ptrain.albedo_only_filter)
    ts = ptrain.make_train_state(start, ptrain.adam(0.01))
    ts, _ = step(ts, target)
    march_kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_TRAIN_STEPS):
        ts, loss = step(ts, target)
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / MESH_TRAIN_STEPS
    launches = dict(march_kernel.LAUNCHES)
    if not (np.isfinite(float(loss)) and launches["k1a"]
            and sum(launches.values()) == launches["k1a"]):
        raise AssertionError(f"[10e] loss {float(loss)}, launches "
                             f"{launches}")
    per = launches["k1a"] / MESH_TRAIN_STEPS
    calls = record_step(lambda: step(ts, target))
    held = hold_calls("10e (4,2)", calls)
    if set(held) != {"k1a"} or held["k1a"][0] != per:
        raise AssertionError(f"[10e] recorded calls {held}, {per} a step")
    log(f"[10e] train step on the (4,2) mesh, Cornell full 480x480, 8 "
        f"bounces, albedo only: {s_step:.4f} s/step over "
        f"{MESH_TRAIN_STEPS} steps (8e's one-card step {train_8e:.4f}); K1a "
        f"{per:g} launches a step, the {held['k1a'][0]} calls of one step "
        f"({calls[0][1][0].shape[0]} lanes each) bit-equal to the plain "
        f"march; loss {float(loss):.6f}")

    fresh = lambda: ptrain.make_train_state(start, ptrain.adam(0.01))
    ref, want = written_out_step(fresh(), env, cam, cfg, target,
                                 ptrain.material_only_filter)
    pref = scenelib.params(ref.scene)
    same = {}
    for name, mesh in (("1x1", pmesh.make_mesh(1, 1)), ("None", None)):
        st = ptrain.make_sharded_train_step(
            env, cam, cfg, mesh, spp=1,
            param_filter=ptrain.material_only_filter)
        got, loss = st(fresh(), target)
        pgot = scenelib.params(got.scene)
        if not (same_bits(loss.reshape(()), want) and all(
                torch.allclose(x, y, rtol=1e-5, atol=0)
                for x, y in zip(pgot, pref))):
            raise AssertionError(f"[10e] mesh {name}'s step differs from the "
                                 f"step written out")
        same[name] = all(same_bits(x, y) for x, y in zip(pgot, pref))
    log(f"[10e] a 1x1 mesh's step and mesh None's against the one-card step "
        f"written out, materials only: loss bit-identical, the scene within "
        f"rtol 1e-5 (" + ", ".join(
            f"{k}: {'bit-identical' if v else 'not bit-identical'}"
            for k, v in same.items()) + ")")
    return dict(s=s_step, s_8e=train_8e, launches=per,
                held_calls=held["k1a"][0], one_by_one_same=same)


def phase_item16(dev):
    """10f: ``apps.denoise_demo.run`` at 768x432 on the card, DENOISE_STEPS
    steps timed; DENOISE_HELD steps within 1e-5 of the same steps on the
    CPU; ``calc_normal_tetrahedron`` on the card against the CPU on the
    Cornell full box (atol 2e-4: the estimate differences distances 0.003
    apart); the share of 2^22 quotients on which the card's division by a
    host scalar, and by a tensor on the card, rounds apart from the
    CPU's."""
    denoise_demo.run(steps=2, device=dev)
    secs, _ = timed_s(lambda: denoise_demo.run(steps=DENOISE_STEPS,
                                               device=dev))
    got = denoise_demo.run(steps=DENOISE_HELD, device=dev)
    ref = denoise_demo.run(steps=DENOISE_HELD, device="cpu")
    err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    if err > 1e-5:
        raise AssertionError(f"[10f] denoise demo card vs CPU: {err}")
    scene = cornell.full_scene(dev)
    rng = np.random.default_rng(0)
    p = torch.as_tensor(rng.uniform(-1, 1, (4096, 3)).astype(np.float32),
                        device=dev)
    idx, _ = scenelib.nearest(scene, p)
    n_card = scenelib.calc_normal_tetrahedron(scene, idx, p)
    n_cpu = scenelib.calc_normal_tetrahedron(cornell.full_scene("cpu"),
                                             idx.cpu(), p.cpu())
    nerr = float((n_card.cpu() - n_cpu).abs().max())
    if nerr > 2e-4:
        raise AssertionError(f"[10f] tetrahedron normal card vs CPU {nerr}")
    ms = secs / DENOISE_STEPS * 1e3
    # why the demo divides by tensors on the card: CUDA's division by a
    # host scalar is a multiply by its reciprocal
    x = torch.rand(1 << 22, generator=torch.Generator().manual_seed(0)) * 1e3
    xc = x.to(dev)
    apart = {d: (float(((xc / d).cpu() != x / d).float().mean()),
                 float(((xc / torch.tensor(d, device=dev)).cpu() != x / d)
                       .float().mean())) for d in (768.0, 432.0, 480.0)}
    log(f"[10f] denoise demo 768x432 on the card: {ms:.4f} ms a step over "
        f"{DENOISE_STEPS} steps; {DENOISE_HELD} steps within {err:.3e} of "
        f"the CPU's; calc_normal_tetrahedron at 4096 points within "
        f"{nerr:.3e} of the CPU's; x / d on the card apart from the CPU's "
        f"on (a host scalar d, a tensor d on the card) of 2^22 values: "
        + ", ".join(f"d={d:g} {a:.5f} / {b:.5f}" for d, (a, b)
                    in apart.items()))
    return dict(ms_step=ms, err=err, normal_err=nerr, division=apart)


def sharded_phases(dev, train_8e):
    """10a-10f. Returns what the kernels line reads."""
    t0 = time.perf_counter()
    stills = phase_sharded_stills(dev)
    frames = phase_sharded_frames(dev)
    procs = phase_sharded_processes(dev)
    scaling_out = phase_scaling(dev)
    train = phase_mesh_train(dev, train_8e)
    item16 = phase_item16(dev)
    log(f"[10] distributed and item 16 phases ({card_line()}): "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(stills=stills, frames=frames, procs=procs,
                scaling=scaling_out, train=train, item16=item16)


# --- the bench: bench_torch.py, the workload rows, NEE, adaptive -----------

def run_entry(label, args):
    """``python3 args`` in a fresh process from the repo root, as a user
    runs it: rc 0, its stderr logged, its one ``bench.RECORD`` line read.
    Returns (stdout's lines, the record, seconds)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, *args], cwd=REPO, text=True,
                       capture_output=True, timeout=BENCH_TIMEOUT)
    secs = time.perf_counter() - t0
    for line in p.stderr.splitlines():
        log(f"[11] {label}: {line}")
    if p.returncode:
        raise AssertionError(f"{label}: rc {p.returncode}; stdout "
                             f"{p.stdout[-2000:]}")
    rec = [json.loads(line[len(bench.RECORD):])
           for line in p.stderr.splitlines()
           if line.startswith(bench.RECORD)]
    if len(rec) != 1:
        raise AssertionError(f"{label}: {len(rec)} record lines")
    log(f"[11] {label}: rc 0 in {secs:.1f} s")
    return p.stdout.splitlines(), rec[0], secs


def hold_bench_frames(dev):
    """The bench's paths that no other phase marches, held call by call:
    the second frame of ``bench.nee_setup``'s sun-lit spheres with NEE on
    (the bounces through K1a, the shadow rays through K1b's escape-bound
    instance) and of the Cornell minimal 512x512 workload row (K1a); each
    recorded call bit-equal to the plain march on its inputs. Returns
    {frame: {kind: (calls, max abs err)}}."""
    scene, _, env_s, cam, cfg = bench.nee_setup(dev)
    (_, mscene, menv, mcam, mcfg), = bench.workload_rows(
        dev, (bench.ROW_MINIMAL,))
    out = {}
    for label, sc, env, cm, c, per_step, kinds in (
            (f"NEE spheres {bench.NEE_RES}x{bench.NEE_RES}", scene, env_s,
             cam, cfg.replace(env_sampling=True), 2, ("k1a", "k1b")),
            (bench.ROW_MINIMAL, mscene, menv, mcam, mcfg, 1, ("k1a",))):
        _, state = render_frame(sc, env, cm,
                                make_frame_state(c.num_pixels, device=dev),
                                c)
        calls, _ = capture_frame(sc, env, cm, c, state, per_step)
        out[label] = hold_calls(f"11 {label}", [(sc, x) for x in calls],
                                "frame")
        if tuple(sorted(out[label])) != kinds:
            raise AssertionError(f"[11] {label}: calls of {out[label]}, "
                                 f"expected {kinds}")
    return out


def phase_bench(dev):
    """11: ``python3 bench_torch.py`` and ``tools/bench_workloads_torch.py``
    as fresh processes (rc 0; bench.py's eleven keys and ``device``, every
    number finite and above 0, the card's name and power limit; the
    headline's K1a launches 4 a frame and no other march kernel; all six
    rows at their native resolution, each row's kernel 4 launches a frame),
    then ``bench.nee_equal_time`` and ``bench.adaptive_payoff`` in this
    process at a tenth of the JAX scripts' budgets, and one frame of each
    path no other phase marches held call by call against the plain march
    (:func:`hold_bench_frames`). At a tenth of its frames the adaptive
    bench leaves every pixel active, so its gate and compacted frames do
    no work here: 9c holds the gate. Returns what the kernels line
    reads."""
    t0 = time.perf_counter()
    lines, rec, bench_s = run_entry("bench_torch.py", ["bench_torch.py"])
    out = json.loads(lines[-1])
    if tuple(out) != bench.KEYS + ("device",):
        raise AssertionError(f"bench_torch.py keys: {list(out)}")
    bench.check_positive("bench_torch.py", {
        k: v for k, v in out.items() if k not in ("metric", "unit",
                                                  "device")})
    name, _, limit = card_line().rpartition(", ")
    if out["device"] != {"name": name, "power_limit": limit}:
        raise AssertionError(f"bench_torch.py device: {out['device']}")
    head, frames = rec["launches"]["headline"], rec["headline"]["frames"]
    want = {k: 4 * frames if k == "k1a" else 0 for k in head["march"]}
    if head["march"] != want or any(head["bound"].values()):
        raise AssertionError(f"headline launches {head} over {frames} "
                             f"frames")
    log(f"[11] bench_torch.py: {json.dumps(out)}; K1a {head['march']['k1a']}"
        f" launches in {frames} frames")

    lines, wrec, rows_s = run_entry("tools/bench_workloads_torch.py",
                                    ["tools/bench_workloads_torch.py"])
    rows = wrec["rows"]
    if tuple(r["name"] for r in rows) != bench.ROWS:
        raise AssertionError(f"workload rows {[r['name'] for r in rows]}")
    for r in rows:
        bench.check_positive(r["name"], {k: r[k] for k in ("msps", "ms",
                                                        "samples")})
        if f"| {r['name']} |" not in "\n".join(lines):
            raise AssertionError(f"{r['name']}: not in the table")
    log("[11] tools/bench_workloads_torch.py:\n" + "\n".join(lines))

    tenth = {k: tuple(x / BENCH_SHARE for x in v) if isinstance(v, tuple)
             else v / BENCH_SHARE for k, v in bench.NEE_BUDGETS.items()}
    nee = bench.nee_equal_time(dev, **tenth)
    bench.check_kinds("[11] nee_equal_time", nee["launches"], ("k1a", "k1b"))
    if nee["launches"]["bound"]["k1b"] != nee["launches"]["march"]["k1b"]:
        raise AssertionError(f"[11] NEE: K1b launched beside the shadow "
                             f"rays: {nee['launches']}")
    for run in nee["runs"]:
        # a PSNR of a short run's linear image may be below 0 dB
        bench.check_positive(f"[11] NEE {run['seconds']} s", {
            f"{k} {f}": run[k][f] for k in ("plain", "nee")
            for f in ("msps", "spp")})
        if not all(np.isfinite(run[k]["psnr"]) for k in ("plain", "nee")):
            raise AssertionError(f"[11] NEE PSNR not finite: {run}")
    bench.check_positive("[11] NEE diet", {
        "on": nee["diet"]["on"]["msps"], "off": nee["diet"]["off"]["msps"],
        "truth spp": nee["truth_spp"]})
    log(f"[11] nee_equal_time at {tenth}: {json.dumps(nee)}")
    frames = {k: v // BENCH_SHARE for k, v in bench.ADAPTIVE_FRAMES.items()}
    ada = bench.adaptive_payoff(dev, **frames)
    bench.check_kinds("[11] adaptive_payoff", ada["launches"], ("k1a",))
    bench.check_positive("[11] adaptive", {
        f"{a} {k}": v for a in (False, True) for k, v in ada[a].items()
        if k != "active"})
    log(f"[11] adaptive_payoff at {frames}: "
        f"{json.dumps({str(k): v for k, v in ada.items()})}")
    held = hold_bench_frames(dev)
    log(f"[11] the bench ({card_line()}): {time.perf_counter() - t0:.1f} s "
        f"(bench_torch.py {bench_s:.1f} s, the rows {rows_s:.1f} s)")
    return dict(out=out, launches=rec["launches"], rows=rows, nee=nee,
                adaptive=ada, held=held)


# --- 12: the counter RNG kernel ----------------------------------------------


def record_draws(fn):
    """Runs ``fn()`` with every CUDA draw's arguments and outputs recorded
    (cloned). Returns (what fn returned, [(pixel_id, step, stream, seed,
    dtype, rows, r2, outputs)])."""
    real, draws = rng_kernel.draw, []

    def record(pixel_id, step, stream, seed=0, dtype=torch.float32, rows=4,
               r2=False):
        out = real(pixel_id, step, stream, seed, dtype, rows=rows, r2=r2)
        keep = step.clone() if isinstance(step, torch.Tensor) else step
        draws.append((pixel_id.clone(), keep, stream, seed, dtype, rows, r2,
                      tuple(o.clone() for o in out)))
        return out
    rng_kernel.draw = record
    try:
        result = fn()
    finally:
        rng_kernel.draw = real
    torch.cuda.synchronize()
    return result, draws


def plain_draw(pixel_id, step, stream, seed=0, dtype=torch.float32, rows=4,
               r2=False):
    """``rng_kernel.draw``'s stand-in: the plain draw on the same
    tensors."""
    f = trng.r2_uniform4_plain if r2 else trng.uniform4_plain
    return f(pixel_id, step, stream, seed, dtype)[:rows]


def with_plain_draws(fn):
    """``fn()`` with every CUDA draw made by the plain draws."""
    real = rng_kernel.draw
    rng_kernel.draw = plain_draw
    try:
        return fn()
    finally:
        rng_kernel.draw = real


def hold_draws(label, draws):
    """Each recorded draw bit-equal to the plain draw on its inputs.
    Returns the draws by mode and rows."""
    kinds = {}
    for pid, step, stream, seed, dtype, rows, r2, out in draws:
        ref = plain_draw(pid, step, stream, seed, dtype, rows, r2)
        for k, (a, b) in enumerate(zip(out, ref)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{label}: draw (stream {stream}, r2 {r2}) row {k}: "
                    f"{int((a != b).sum())} of {a.numel()} lanes differ")
        key = f"{'r2_uniform4' if r2 else 'uniform4'} x{rows}"
        kinds[key] = kinds.get(key, 0) + 1
    log(f"[12] {label}: every draw bit-equal to the plain draw: {kinds}")
    return kinds


def rng_alone(dev):
    """The kernel alone at the Cornell frame's 230,400 lanes and the glass
    frame's 2,073,600: back to back (:func:`device_ms`), each launch on
    ids and steps that the three before it did not touch (4 sets of
    inputs, above the 50 MB L2 at 2 M lanes), against its byte bound:
    the ids (8 B) and a per-lane step (8 B) read once, the floats (4 B a
    row) written once, at 3.35 TB/s. The plain draw beside it (CUDA
    events, median)."""
    out = {}
    for n in RNG_LANES:
        gen = torch.Generator(device=dev).manual_seed(n)
        pids = [torch.randint(0, 2**32, (n,), generator=gen,
                              dtype=torch.int64, device=dev)
                for _ in range(4)]
        lanes = [torch.randint(0, 2**32, (n,), generator=gen,
                               dtype=torch.int64, device=dev)
                 for _ in range(4)]
        frame = torch.tensor(41, device=dev)
        for label, fn, rows, lane in (
                ("uniform4, step on the card", trng.uniform4, 4, False),
                ("uniform, step on the card", trng.uniform, 1, False),
                ("r2_uniform4, step a lane", trng.r2_uniform4, 4, True)):
            turn = itertools.cycle(range(4))

            def call(fn=fn, lane=lane, turn=turn):
                k = next(turn)
                return fn(pids[k], lanes[k] if lane else frame, 1, 7)
            ms = device_ms(call, reps=RNG_REPS)
            plain = (trng.r2_uniform4_plain if fn is trng.r2_uniform4
                     else trng.uniform4_plain)
            plain_ms = median_ms(lambda: plain(
                pids[0], lanes[0] if lane else frame, 1, 7))
            nbytes = n * (8 + (8 if lane else 0) + 4 * rows)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            key = f"{label}, {n} lanes"
            out[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bytes_per_lane": nbytes // n, "share": bound / ms}
            log(f"[12] {key}: kernel {ms:.5f} ms back to back, plain "
                f"{plain_ms:.4f} ms; bound {bound:.5f} ms ({nbytes // n} B "
                f"a lane), share {100 * bound / ms:.1f}%")
    return out


def phase_rng(dev):
    """12: the counter RNG kernel. Alone (:func:`rng_alone`). Then one
    glass frame at 1920x1080 (``bunny_config``, the scene animated to
    frame 12, after two frames from a fresh state) with every draw
    recorded: 3 draws a step, one launch each, every one bit-equal to the
    plain draw; the same frame from the same state with the plain draws:
    pixels and state bit-identical. Then one scan-AD step of the Cornell
    box at 8 bounces (8a's) with every draw recorded and held; its
    albedo gradient against the same step with the plain draws within
    rtol 1e-5. Returns what the kernels line reads."""
    out = {"alone": rng_alone(dev)}
    cfg = bunny_config()
    scene = bunny.animated_scene(bunny.glass_scene(dev),
                                 torch.tensor(12.0, device=dev))
    env = bunny.glass_environment(device=dev)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    state = make_frame_state(cfg.num_pixels, device=dev)
    for _ in range(2):
        _, state = render_frame(scene, env, cam, state, cfg)
    rng_kernel.reset_launches()
    (px, st), draws = record_draws(
        lambda: render_frame(scene, env, cam, state, cfg))
    frame_launches = dict(rng_kernel.LAUNCHES)
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    if not (sum(frame_launches.values()) == len(draws) == 3 * steps):
        raise AssertionError(f"[12] glass frame: {len(draws)} draws, "
                             f"launches {frame_launches}, {steps} steps")
    frame = hold_draws(f"glass frame {cfg.width}x{cfg.height}", draws)
    del draws
    px_p, st_p = with_plain_draws(
        lambda: render_frame(scene, env, cam, state, cfg))
    torch.cuda.synchronize()
    same = [k for k in ("accum", "respawn", "hit_t", "march_state",
                        "march_cum") if torch.equal(getattr(st, k),
                                                    getattr(st_p, k))]
    if not torch.equal(px, px_p) or len(same) != 5:
        raise AssertionError(f"[12] glass frame with the plain draws: "
                             f"pixels equal {torch.equal(px, px_p)}, "
                             f"state fields equal {same}")
    log(f"[12] glass frame: pixels and state bit-identical with the plain "
        f"draws; {frame_launches} launches")
    del px, st, px_p, st_p, state

    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    gcfg = grad_config(8)
    rng_kernel.reset_launches()
    g, draws = record_draws(
        lambda: albedo_grad(scene, env, cam, gcfg, True, 5))
    step_launches = dict(rng_kernel.LAUNCHES)
    if sum(step_launches.values()) != len(draws) or not draws:
        raise AssertionError(f"[12] scan-AD step: {len(draws)} draws, "
                             f"launches {step_launches}")
    step = hold_draws("Cornell scan-AD step, 8 bounces", draws)
    g_p = with_plain_draws(
        lambda: albedo_grad(scene, env, cam, gcfg, True, 5))
    torch.testing.assert_close(g, g_p, rtol=1e-5, atol=0)
    log(f"[12] scan-AD step: the albedo gradient within rtol 1e-5 of the "
        f"plain draws' step; {step_launches} launches")
    out.update(frame=frame, frame_launches=frame_launches, step=step,
               step_launches=step_launches)
    return out


def normal_hits(dev):
    """The primary hits of the tokyo frame at 2880x1620 (K1b, the full
    512-trip march) and of the Cornell frame at 480x480 (K1a): {label:
    (scene, index, position)}, missed lanes included (object 0 at a far
    point)."""
    tokyo = bench.k1b_paths(dev)["tokyo 2880x1620"]
    out = {}
    for label, (scene, _, cam, cfg) in (
            ("tokyo 2880x1620", tokyo),
            ("Cornell 480x480", (cornell.full_scene(dev), None,
                                 cornell.full_camera(dev),
                                 cornell.full_config()))):
        o, d = bench.utilization_rays(cfg, cam)
        res = march.march(scene, o, d, cfg)
        out[label] = (scene, res.index, res.position)
    return out


def same_normals(got, want) -> int:
    """Lanes whose normal differs from ``want``'s in any bit (NaN alike
    with NaN, a zero's sign counted)."""
    same = ((got == want) & (torch.signbit(got) == torch.signbit(want))
            | (torch.isnan(got) & torch.isnan(want)))
    return int((~same.all(-1)).sum())


def normal_alone(dev):
    """The kernel alone on each frame's primary hits (:func:`normal_hits`):
    back to back (:func:`device_ms`), each launch on one of four copies of
    the inputs (above the 50 MB L2 at tokyo's lanes), against its byte
    bound: the point (12 B) and the index (4 B) read once, the normal (12
    B) written once, at 3.35 TB/s. ``calc_normal_closed_plain`` and
    autograd's normal beside it (CUDA events, median); every lane of the
    kernel's normal against autograd's."""
    out = {}
    for label, (scene, idx, p) in normal_hits(dev).items():
        n = idx.shape[0]
        got = scenelib.calc_normal(scene, idx, p)
        autograd = scenelib.calc_normal_autograd(scene, idx, p)
        differ = same_normals(got, autograd)
        if differ:
            raise AssertionError(f"[13] {label}: {differ} of {n} lanes "
                                 f"differ from autograd's normal")
        copies = [(idx.clone(), p.clone()) for _ in range(4)]
        turn = itertools.cycle(copies)
        ms = device_ms(lambda: scenelib.calc_normal(scene, *next(turn)),
                       reps=NORMAL_REPS)
        plain_ms = median_ms(
            lambda: scenelib.calc_normal_closed_plain(scene, idx, p))
        autograd_ms = median_ms(
            lambda: scenelib.calc_normal_autograd(scene, idx, p))
        nbytes = n * (12 + idx.element_size() + 12)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        key = f"{label} primaries, {n} lanes"
        out[key] = {"ms": ms, "plain_ms": plain_ms,
                    "autograd_ms": autograd_ms, "bound_ms": bound,
                    "bytes_per_lane": nbytes // n, "share": bound / ms}
        log(f"[13] {key}: kernel {ms:.5f} ms back to back, plain "
            f"{plain_ms:.4f} ms, autograd {autograd_ms:.4f} ms; bound "
            f"{bound:.5f} ms ({nbytes // n} B a lane), share "
            f"{100 * bound / ms:.1f}%; every lane bit-equal to autograd's")
        del copies, got, autograd
    return out


def phase_normal(dev):
    """13: the analytic normal kernel. Alone (:func:`normal_alone`). Then
    one tokyo frame at 2880x1620 (the bench's row, after two frames from a
    fresh state) and one Cornell frame at 480x480, each with the kernel
    and, from the same state, with autograd's normal in its place: pixels
    and state bit-identical. Returns what the kernels line reads."""
    out = {"alone": normal_alone(dev), "frame_launches": {}}
    rows = {"tokyo 2880x1620": bench.k1b_paths(dev)["tokyo 2880x1620"],
            "Cornell 480x480": (cornell.full_scene(dev), cornell.sky(dev),
                                cornell.full_camera(dev),
                                cornell.full_config())}
    kernel = normal_kernel.calc_normal
    for label, (scene, env, cam, cfg) in rows.items():
        state = make_frame_state(cfg.num_pixels, device=dev)
        for _ in range(2):
            _, state = render_frame(scene, env, cam, state, cfg)
        normal_kernel.reset_launches()
        px, st = render_frame(scene, env, cam, state, cfg)
        torch.cuda.synchronize()
        out["frame_launches"][label] = normal_kernel.LAUNCHES["normal"]
        normal_kernel.calc_normal = scenelib.calc_normal_autograd
        try:
            px_a, st_a = render_frame(scene, env, cam, state, cfg)
        finally:
            normal_kernel.calc_normal = kernel
        torch.cuda.synchronize()
        fields = ("accum", "respawn", "hit_t", "march_state", "march_cum")
        same = [k for k in fields if torch.equal(
            torch.nan_to_num(getattr(st, k)),
            torch.nan_to_num(getattr(st_a, k)))]
        if not torch.equal(px, px_a) or len(same) != len(fields):
            raise AssertionError(f"[13] {label} frame with autograd's "
                                 f"normal: pixels equal "
                                 f"{torch.equal(px, px_a)}, state fields "
                                 f"equal {same}")
        log(f"[13] {label} frame: pixels and state bit-identical with "
            f"autograd's normal; {out['frame_launches'][label]} normal "
            f"launches a frame")
        del px, st, px_a, st_a, state
    return out


def material_grad_alone(dev):
    """The kernel alone (:data:`MATERIAL_CASES`) on field gradients drawn
    about 1 and object ids drawn uniformly: back to back
    (:func:`device_ms`), each call on one of four copies of the inputs
    (above the 50 MB L2 at the glass step's lanes), against its byte
    bound: the int32 index (4 B) and each needed column (4 B) read once at
    3.35 TB/s. Beside it (CUDA events, median): the plain backward
    (``material_grad_plain``, an ``index_add_`` a needed part) and, as
    ``library_ms``, ``index_select``'s backward as the gather ran it
    before: ``index_add_`` of the lanes' (N, 10) gradient, int64 ids, into
    the zero table. Every entry within 1e-5 of a float64 sum's absolute
    size."""
    out = {}
    mgk = material_grad_kernel
    for label, n, n_obj, names in MATERIAL_CASES:
        gen = torch.Generator(device=dev).manual_seed(n + len(names))
        needs = [k in names for k in mgk.PART_NAMES]
        copies = []
        for _ in range(4):
            idx = torch.randint(0, n_obj, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            grads = [1.0 + torch.randn((n, k) if k > 1 else (n,),
                                       generator=gen, device=dev)
                     if need else None
                     for need, k in zip(needs, mgk.PART_WIDTHS)]
            copies.append((idx, grads))
        idx, grads = copies[0]
        got = mgk.material_grad_cuda(idx, grads, needs, n_obj)
        f64 = mgk.material_grad_plain(
            idx, [g if g is None else g.double() for g in grads], needs,
            n_obj, torch.float64)
        size = mgk.material_grad_plain(
            idx, [g if g is None else g.double().abs() for g in grads],
            needs, n_obj, torch.float64)
        worst = max(float(((g.double() - r).abs() / a).max())
                    for g, r, a in zip(got, f64, size) if g is not None)
        if not worst <= 1e-5:
            raise AssertionError(f"[14] {label}: {worst:.3e} of the sum's "
                                 f"absolute size from float64")
        turn = itertools.cycle(copies)

        def call():
            i, g = next(turn)
            return mgk.material_grad_cuda(i, g, needs, n_obj)

        ms = device_ms(call, reps=MATERIAL_REPS)
        plain_ms = median_ms(lambda: mgk.material_grad_plain(
            idx, grads, needs, n_obj, torch.float32))
        table = torch.randn((n, 10), generator=gen, device=dev)
        ids64 = idx.to(torch.int64)
        library_ms = median_ms(lambda: torch.zeros(
            (n_obj, 10), device=dev).index_add_(0, ids64, table))
        cols = sum(k for need, k in zip(needs, mgk.PART_WIDTHS) if need)
        nbytes = n * (4 + 4 * cols)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        key = f"{label}, {n} lanes, {n_obj} objects"
        out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound, "bytes_per_lane": nbytes // n,
                    "share": bound / ms, "err": worst}
        log(f"[14] {key}: kernel {ms:.5f} ms back to back, plain "
            f"{plain_ms:.4f} ms, index_select's backward {library_ms:.4f} "
            f"ms; bound {bound:.5f} ms ({nbytes // n} B a lane), share "
            f"{100 * bound / ms:.1f}%; {worst:.2e} of the absolute size "
            f"from float64")
        del copies, got, table, ids64
    return out


def step_routes(step):
    """``step()`` with the material kernel's calls, ``materials_at``'s
    routes and ``calc_normal``'s routes counted over it."""
    material_grad_kernel.reset_launches()
    before = (dict(scenelib.MATERIAL_ROUTES), dict(scenelib.NORMAL_ROUTES))
    step()
    torch.cuda.synchronize()
    return {"material_grad_calls": material_grad_kernel.LAUNCHES[
                "material_grad"],
            "materials_at": {k: v - before[0][k] for k, v
                             in scenelib.MATERIAL_ROUTES.items()},
            "calc_normal": {k: v - before[1][k] for k, v
                            in scenelib.NORMAL_ROUTES.items()}}


def phase_material_grad(dev):
    """14: the material gradient kernel. Alone
    (:func:`material_grad_alone`). Then the kernel's calls and the routes
    of one Cornell scan-AD step at 480x480 (the albedo) and one glass
    step at 1920x1080 (the MLP, the matrix and the albedo), 8 bounces
    each. Returns what the kernels line reads."""
    out = {"alone": material_grad_alone(dev), "steps": {}}
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    gcfg = grad_config(8)
    albedo_grad(scene, env, cam, gcfg, True, 4)
    out["steps"]["Cornell scan-AD 480x480"] = step_routes(
        lambda: albedo_grad(scene, env, cam, gcfg, True, 5))
    scene, env = bunny.glass_scene(dev), bunny.glass_environment(device=dev)
    cfg = bunny.glass_config().replace(max_raytrace=8)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    out["steps"]["glass scan-AD 1920x1080"] = step_routes(
        lambda: bunny_step(scene, env, cam, cfg, 5))
    for label, r in out["steps"].items():
        log(f"[14] {label}, 8 bounces: {r}")
    return out


def main():
    t_start = time.perf_counter()
    dev = phase_device()
    build_s = phase_build()
    stamp = lambda done: log(f"[t] {done} by "
                             f"{time.perf_counter() - t_start:.1f} s")
    stamp("the build")
    benched = phase_bench(dev)
    stamp("the bench (11)")
    drawn = phase_rng(dev)
    stamp("the RNG kernel (12)")
    normals = phase_normal(dev)
    stamp("the normal kernel (13)")
    material_grads = phase_material_grad(dev)
    stamp("the material gradient kernel (14)")
    err_2, k2_ms, k2_plain, k2_bound = phase_k2(dev)
    err_a, ka_ms, pa_ms, cornell_state = phase_kernel_vs_plain(dev)
    err_c, kc_ms, pc_ms, glass_state = phase_k1c_vs_plain(dev)
    err_b, times_b, states_b = phase_k1b_vs_plain(dev)
    err_d, kd_ms, pd_ms = phase_k1d_vs_plain(dev, glass_state)
    stamp("the kernels against the plain march (1b-2c)")
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
    stamp("the frames (3-3f)")
    err_c = max(err_c, e_c, in_frame["glass 1920x1080, K1c"]["err"],
                in_frame["metal 3840x2160, K1c"]["err"])
    err_d = max(err_d, e_d, in_frame["glass 1920x1080, K1d"]["err"],
                in_frame["metal 3840x2160, K1d"]["err"])
    phase_golden(dev)
    phase_golden_demo(dev)
    mega_cornell, mega_minimal, cornell_rec = phase_megakernel_cornell(dev)
    mega_glass, _, glass_q99, glass_rec = phase_megakernel_glass(dev)
    mega_a, mega_cd = phase_megakernel_calls(cornell_rec, glass_rec)
    err_a = max(err_a, mega_a["err"])
    err_c = max(err_c, mega_cd[f"{GLASS_CALLS}, K1c"]["err"])
    err_d = max(err_d, mega_cd[f"{GLASS_CALLS}, K1d"]["err"])
    goldens = phase_goldens_megakernel(dev)
    offline_s = phase_offline_app()
    stamp("the goldens, the megakernel and the offline app (4-3l)")
    nee = nee_phases(dev)
    stamp("NEE (7a-7f)")
    grads = gradient_phases(dev)
    stamp("the gradients (8a-8e)")
    bunny_grads = bunny_gradient_phases(dev)
    stamp("the bunny's gradients (8f-8g)")
    err_c = max(err_c, bunny_grads["scan"][False]["held"]["err"],
                bunny_grads["train"]["held"]["err"])
    err_d = max(err_d, bunny_grads["scan"][True]["held"]["err"])
    comp = compaction_phases(dev)
    del cornell_rec, glass_rec
    stamp("compaction and reprojection (9c-9e)")
    shard = sharded_phases(dev, grads["train"]["s"])
    stamp("the distributed phases (10a-10f)")
    err_a = max(err_a, grads["err_a"], *(v["k1a"][1] for v
                                         in benched["held"].values()))
    err_b = max(err_b, grads["err_b"], *(v["k1b"][1] for v
                                         in benched["held"].values()
                                         if "k1b" in v))
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
    stamp("the utilization (5)")

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

    def bunny_gradients(e, mxu):
        """K1c's or K1d's entry with its launches a bunny scan-AD step (8f)
        and a train step (8g, K1c), and the 8f step's own calls: the
        kernel's ms on the whole calls, and on every GLASS_SUBSET-th lane
        against that subset's bound."""
        scan = bunny_grads["scan"][mxu]
        h = scan["held"]
        e["bunny_gradients"] = {
            "launches_per_step": {
                "scan-AD glass 1920x1080, 8 bounces":
                    scan["launches"]["k1d" if mxu else "k1c"]},
            "step_calls_ms": h["ms"], "subset_calls_ms": h["sub_ms"],
            "subset_calls_bound_ms": h["bound_ms"],
            "subset_calls_share": h["bound_ms"] / h["sub_ms"]}
        if not mxu:
            e["bunny_gradients"]["launches_per_step"][
                "train step glass 1920x1080, 8 bounces"] = (
                bunny_grads["train"]["launches"])
        return e
    per_frame = lambda rp: (comp["reproj"][rp][0]["launches"]
                            / len(REPROJECT_SCRIPT))
    kernels = [
        megakernel(analytic(entry(
            "march_k1a", "march.cu", f"{TPU_KERNEL}:297", launch_a, err_a,
            ka_ms, pa_ms, bound("k1a")), ("cornell 480x480",)),
            mega_cornell["bounces"], mega_a) | g_a
        | {"compaction": {"adaptive_launches_per_frame":
                          comp["adaptive"]["launches_per_frame"]}},
        shadow_frames(analytic(entry(
            "march_k1b", "march.cu", f"{TPU_KERNEL}:338", launch_b, err_b,
            kb_ms, pb_ms, bound("k1b")), ("tokyo 2880x1620",
                                          "engine 768x432"))
            | {"megakernel": {"golden_launches": k1b_goldens}} | g_b)
        | {"compaction": {"interactive_launches_per_frame": {
            "reproject": per_frame(True), "plain": per_frame(False)}}},
        bunny_gradients(shadow_pass(megakernel(
            pooled(entry("march_k1c", "march.cu", f"{TPU_KERNEL}:156",
                         launch_c, err_c, kc_ms, pc_ms, bound("k1c")), "k1c",
                   ("glass 1920x1080, K1c", "metal 3840x2160, K1c")),
            mega_glass[False][0]["bounces"], mega_cd[f"{GLASS_CALLS}, K1c"]),
            "glass NEE shadow, K1c", False), False),
        bunny_gradients(shadow_pass(megakernel(
            pooled(entry("march_k1d", "march_mxu.cu", f"{TPU_KERNEL}:124",
                         launch_d, err_d, kd_ms, pd_ms, bound("k1d")), "k1d",
                   ("glass 1920x1080, K1d", "metal 3840x2160, K1d")),
            mega_glass[True][0]["bounces"], mega_cd[f"{GLASS_CALLS}, K1d"]),
            "glass NEE shadow, K1d", True), True),
        entry("fma_chains_k2", "speedlight.cu",
              "raytracingpbr_tpu/utils/speedlight.py:94", launch_2, err_2,
              k2_ms, k2_plain, (k2_bound, "operations"))]
    # the sharded paths' launches (10a: a pass of each mesh; 10b: a frame;
    # 10c: the NCCL world's run; 10e: a mesh train step)
    kernels[0]["sharded"] = {
        "still_launches_per_pass": {k: v["k1a_per_pass"]
                                    for k, v in shard["stills"].items()},
        "frame_launches_per_frame": {
            k: v["k1a_per_frame"] for k, v in shard["frames"].items()
            if "k1a_per_frame" in v},
        "nccl_world_launches": shard["procs"]["nccl_k1a"],
        "mesh_train_launches_per_step": shard["train"]["launches"]}
    kernels[1]["sharded"] = {"engine_reprojected_launches_per_frame": shard[
        "frames"]["engine (8,1) strided, reprojected"]["k1b_per_frame"]}
    # the bench's launches (11): bench_torch.py's protocols and the
    # workload rows in their own processes, nee_equal_time and
    # adaptive_payoff here; each source's count where it launched the kernel
    sources = {
        **{f"bench_torch.py {k}": v for k, v in benched["launches"].items()},
        **{f"workload row {r['name']}": r["launches"]
           for r in benched["rows"]},
        "nee_equal_time": benched["nee"]["launches"],
        "adaptive_payoff": benched["adaptive"]["launches"]}
    for e, k in zip(kernels[:3], ("k1a", "k1b", "k1c")):
        e["bench"] = {src: v["march"][k] for src, v in sources.items()
                      if v["march"][k]}
    # the calls of 11's held frames, each bit-equal to the plain march
    for e, k in zip(kernels[:2], ("k1a", "k1b")):
        e["bench"]["held_calls"] = {f: v[k][0] for f, v
                                    in benched["held"].items() if k in v}
    kernels[4]["bench"] = {src: v["k2"] for src, v in sources.items()
                           if v["k2"]}
    # the counter RNG (12): no TPU kernel (the JAX package's RNG is XLA)
    alone = drawn["alone"]
    kernels.append({
        "name": "rng", "route": "cuda", "source": f"{CSRC}/rng.cu",
        "replaces": "raytracingpbr_tpu/core/rng.py (XLA, no Pallas kernel)",
        "launches": {"glass frame": drawn["frame_launches"],
                     "Cornell scan-AD step": drawn["step_launches"]},
        "draws": {"glass frame": drawn["frame"],
                  "Cornell scan-AD step": drawn["step"]},
        "max_abs_err": 0.0, "ms": {k: v["ms"] for k, v in alone.items()},
        "plain_ms": {k: v["plain_ms"] for k, v in alone.items()},
        "bound_ms": {k: v["bound_ms"] for k, v in alone.items()},
        "bound_by": "bytes", "share": {k: v["share"]
                                       for k, v in alone.items()},
        "library_ms": None,
        "bench": {src: v["rng"] for src, v in sources.items()
                  if any(v.get("rng", {}).values())}})
    # the analytic normal (13): no TPU kernel (the JAX package's is
    # jax.grad)
    alone = normals["alone"]
    kernels.append({
        "name": "normal", "route": "cuda", "source": f"{CSRC}/normal.cu",
        "replaces": "raytracingpbr_tpu/ops/scene.py calc_normal (jax.grad, "
                    "no Pallas kernel)",
        "launches": normals["frame_launches"],
        "max_abs_err": 0.0, "ms": {k: v["ms"] for k, v in alone.items()},
        "plain_ms": {k: v["plain_ms"] for k, v in alone.items()},
        "autograd_ms": {k: v["autograd_ms"] for k, v in alone.items()},
        "bound_ms": {k: v["bound_ms"] for k, v in alone.items()},
        "bound_by": "bytes", "share": {k: v["share"]
                                       for k, v in alone.items()},
        "library_ms": None})
    # the material gather's backward (14): no TPU kernel (the JAX
    # package's gather is a one-hot matmul)
    alone = material_grads["alone"]
    kernels.append({
        "name": "material_grad", "route": "cuda",
        "source": f"{CSRC}/material_grad.cu",
        "replaces": "raytracingpbr_tpu/ops/scene.py materials_at (a one-hot "
                    "matmul under XLA, no Pallas kernel)",
        "launches": material_grads["steps"],
        "max_rel_err": max(v["err"] for v in alone.values()),
        "ms": {k: v["ms"] for k, v in alone.items()},
        "plain_ms": {k: v["plain_ms"] for k, v in alone.items()},
        "bound_ms": {k: v["bound_ms"] for k, v in alone.items()},
        "bound_by": "bytes", "share": {k: v["share"]
                                       for k, v in alone.items()},
        "library_ms": {k: v["library_ms"] for k, v in alone.items()}})
    log(f"[end] the smoke ran {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
