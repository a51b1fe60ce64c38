#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises and exits non-zero):

0.  device: the card's name and power limit, torch / CUDA versions,
    CUDA_HOME, whether triton imports, TF32 matmuls off. No card: fail (no
    CPU fallback).
1.  build the CUDA march kernels (K1a, K1b, K1c: one source) from
    ``raytracingpbr_tpu_torch/csrc``.
2.  K1a vs its plain PyTorch version on the same CUDA tensors at the Cornell
    path's shapes (480x480 primaries chained in budgets of 32 over 512
    trips; the mixed split-march state after 3 plain wavefront steps; an
    all-inactive gate; a ragged N): all eight outputs bit-equal. Median time
    of each version.
2b. K1c and K1b vs the plain version. K1c: bunny glass primaries at 960x540
    (chained budget-32 calls, at most 4), the mixed state after 3 wavefront
    steps of the bunny path at 1920x1080 (made on the card), the metal scene
    (omega 0.9), the scene animated to frame 60, the escape bound, a ragged
    N and an all-inactive gate. K1b: the engine (ROLLBACK_TO_ONE + CONE),
    scene_demo (ROLLBACK_TO_ONE + RELATIVE) and tokyo (ROLLBACK_HALF_UP +
    RELATIVE) configs and the escape bound, on 768x432 primaries and random
    rays. Bit-equal on all eight outputs. Times of each variant, kernel and
    plain, in turns.
3.  the Cornell main path: progressive wavefront frames of the full-PBR
    Cornell box (480x480, 4 steps per frame, 512-trip march in budgets of
    32, black sky, ACES then gamma) as ``bench.py`` times them: 1 + 3
    warm-up frames, 10 timed. K1a must launch 4 times a frame.
3b. the bunny glass path at full width: 1920x1080, 4 steps per frame, the
    2048-trip march in budgets of 32, omega 0.5, the RELATIVE hit test, the
    synthetic HDR sky, the scene animated to frame 12 on the card; 1 + 3
    warm-up frames, 10 timed, then re-animated to frame 13 for one more
    frame. K1c must launch 4 times a frame.
4.  the ``wavefront_cornell_full`` golden rendered on the card: >= 35 dB.
4b. the ``wavefront_scene_demo`` golden on the card (K1b's path): >= 35 dB.

Each path's launch counts are set to 0 just before it and read just after.
The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Imports no jax.
"""
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from raytracingpbr_tpu_torch.core import rng
from raytracingpbr_tpu_torch.core.types import make_frame_state
from raytracingpbr_tpu_torch.io.image import read_png
from raytracingpbr_tpu_torch.kernels import march_kernel
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.ops import camera, march, scene as scenelib
from raytracingpbr_tpu_torch.ops.integrator import (render_frame,
                                                    render_image_progressive)
from raytracingpbr_tpu_torch.utils.metrics import psnr

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "assets", "goldens", "wavefront_cornell_full.png")
GOLDEN_DEMO = os.path.join(REPO, "assets", "goldens",
                           "wavefront_scene_demo.png")
FIELDS = ("t", "index", "hit", "fin", "w", "s", "d", "done")
SOURCE = "raytracingpbr_tpu_torch/csrc/march.cu"
TPU_KERNEL = "raytracingpbr_tpu/pallas/march_kernel.py"

# Sizes of the phases (the main paths' are the workloads' own).
BUNNY_RES = (1920, 1080)      # phase 3b and the K1c mixed state
BUNNY_CMP_RES = (960, 540)    # K1c primaries
K1B_RES = (768, 432)          # K1b primaries
RANDOM_RAYS = 1 << 18         # K1b random rays
TIMED_FRAMES = 10


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


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs the card")
    log("[0] card:", card_line())
    log("[0] torch", torch.__version__, "cuda", torch.version.cuda,
        "devices", torch.cuda.device_count(),
        "name", torch.cuda.get_device_name(0))
    log("[0] CUDA_HOME", os.environ.get("CUDA_HOME"), "nvcc",
        march_kernel.nvcc_path())
    try:
        import triton
        log("[0] triton", triton.__version__)
    except ImportError as e:
        log("[0] triton not importable:", e)
    # the bunny's matmul form (normals) must run in full f32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the bunny MLP needs f32")
    return torch.device("cuda", 0)


def phase_build():
    t0 = time.perf_counter()
    path = march_kernel.build()
    march_kernel.load()
    secs = time.perf_counter() - t0
    log(f"[1] built {os.path.relpath(path, REPO)} in {secs:.2f} s")
    return secs


def compare(scene, o, d, cfg, active=None, init=None):
    """Kernel vs plain on the same inputs; asserts all eight outputs are
    bit-equal. Returns (kernel result, max abs difference)."""
    k = march.ResumableResult(*march_kernel.march_resumable_cuda(
        scene, o, d, cfg, active=active, init=init))
    p = march.march_resumable_plain(scene, o, d, cfg, active=active,
                                    init=init)
    bad = {name: int((a != b).sum()) for name, a, b in zip(FIELDS, k, p)}
    if any(bad.values()):
        raise AssertionError(f"lanes differ between kernel and plain march: "
                             f"{bad}")
    err = max((float((a - b).abs().max()) for a, b in zip(k, p)
               if a.dtype.is_floating_point and a.numel()), default=0.0)
    return k, err


def chain(scene, o, d, cfg, total, max_calls):
    """Chained budget-B calls (B = ``cfg.max_raymarch``) of kernel and
    plain, each compared; stops at convergence, after ``total`` trips or
    after ``max_calls``. Returns (calls, max abs err, lanes unconverged)."""
    live = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    init, calls, err = None, 0, 0.0
    for _ in range(min(total // cfg.max_raymarch, max_calls)):
        k, e = compare(scene, o, d, cfg, active=live, init=init)
        calls, err = calls + 1, max(err, e)
        live = live & (k.done == 0)
        init = (k.t, k.w, k.s, k.d)
        if not bool(live.any()):
            break
    return calls, err, int(live.sum())


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
    mo, md, minit, n_flight = mixed_state(
        cornell.full_scene(), cornell.sky(), cornell.full_camera(), cfg)
    _, e = compare(scene, mo.to(dev), md.to(dev), mcfg,
                   init=tuple(v.to(dev) for v in minit))
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

    # time each version on the fresh budget-32 primary march, in turns
    k_ms, p_ms, ms = in_turns(
        lambda: march_kernel.march_resumable_cuda(scene, o, d, mcfg),
        lambda: march.march_resumable_plain(scene, o, d, mcfg))
    log(f"[2] budget-32 march at {o.shape[0]} lanes: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms (medians, in turns k p p k: "
        f"{', '.join(f'{v:.4f}' for v in ms)})")
    return err, k_ms, p_ms


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
    return err, k_ms, p_ms


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
    err, times = 0.0, {}
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
        log(f"[2b] K1b {label}: {calls} chained budget-32 primary calls "
            f"({unconv} unconverged), random rays fresh + gated resume: "
            f"bit-equal; budget-32 call at {o.shape[0]} lanes: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return err, times


def phase_main_path(dev):
    cfg = main_config()
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    state = make_frame_state(cfg.num_pixels, device=dev)
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    log(f"[3] first frame: {time.perf_counter() - t0:.2f} s")
    for _ in range(3):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    c0 = float(state.accum[:, 3].sum())
    before = march_kernel.LAUNCHES["k1a"]
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c1 = float(state.accum[:, 3].sum())
    launches = dict(march_kernel.LAUNCHES)
    frames = 4 + TIMED_FRAMES
    if (launches["k1a"] - before != steps * TIMED_FRAMES
            or launches != {"k1a": steps * frames, "k1b": 0, "k1c": 0}):
        raise AssertionError(f"expected {steps} K1a launches per frame, "
                             f"got {launches} over {frames} frames")
    check_frame(px, c0, c1)
    msps = (c1 - c0) / dt / 1e6
    log(f"[3] main path 480x480: {dt / TIMED_FRAMES * 1e3:.3f} ms/frame, "
        f"{msps:.4f} Msamples/s, {launches['k1a']} K1a launches in "
        f"{frames} frames")
    return launches["k1a"], dt / TIMED_FRAMES * 1e3, msps


def check_frame(px, c0, c1):
    if not c1 > c0 > 0:
        raise AssertionError(f"accumulator alpha did not grow: {c0} -> {c1}")
    if not (bool(torch.isfinite(px).all()) and float(px.min()) >= 0.0
            and float(px.max()) <= 1.0):
        raise AssertionError("pixels not finite in [0, 1]")


def phase_bunny_path(dev):
    cfg = bunny_config()
    base = bunny.glass_scene(dev)
    scene = bunny.animated_scene(base, torch.tensor(12.0, device=dev))
    env = bunny.glass_environment(device=dev)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    state = make_frame_state(cfg.num_pixels, device=dev)
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    torch.cuda.reset_peak_memory_stats()
    march_kernel.reset_launches()
    t0 = time.perf_counter()
    px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    log(f"[3b] first frame: {time.perf_counter() - t0:.2f} s")
    for _ in range(3):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    c0 = float(state.accum[:, 3].sum())
    before = march_kernel.LAUNCHES["k1c"]
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c1 = float(state.accum[:, 3].sum())
    if march_kernel.LAUNCHES["k1c"] - before != steps * TIMED_FRAMES:
        raise AssertionError(f"expected {steps} K1c launches per frame, "
                             f"got {march_kernel.LAUNCHES}")
    check_frame(px, c0, c1)
    # re-animate on the card (full matrix path, nonzero offset), one frame
    scene13 = bunny.animated_scene(base, torch.tensor(13.0, device=dev))
    assert scene13.rot_perm == (None,)
    assert float(scene13.local_offset.abs().max()) > 0.0
    px, state = render_frame(scene13, env, cam, state, cfg)
    torch.cuda.synchronize()
    c2 = float(state.accum[:, 3].sum())
    check_frame(px, c1, c2)
    launches = dict(march_kernel.LAUNCHES)
    frames = 5 + TIMED_FRAMES
    if launches != {"k1a": 0, "k1b": 0, "k1c": steps * frames}:
        raise AssertionError(f"expected {steps} K1c launches per frame, "
                             f"got {launches} over {frames} frames")
    msps = (c1 - c0) / dt / 1e6
    mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"[3b] bunny glass path {cfg.width}x{cfg.height}: "
        f"{dt / TIMED_FRAMES * 1e3:.3f} ms/frame, {msps:.4f} Msamples/s, "
        f"{launches['k1c']} K1c launches in {frames} frames (frame 13 "
        f"re-animated), peak device memory {mem:.2f} GiB")
    return launches["k1c"], dt / TIMED_FRAMES * 1e3, msps


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
    if not (launches["k1b"] > 0 and launches["k1a"] == launches["k1c"] == 0):
        raise AssertionError(f"the scene_demo path did not run K1b alone: "
                             f"{launches}")
    db = score_golden(img, GOLDEN_DEMO, "wavefront_scene_demo")
    log(f"[4b] wavefront_scene_demo golden on the card: {db:.2f} dB "
        f"({int(state.frame)} frames, {launches['k1b']} K1b launches)")
    return launches["k1b"]


def main():
    dev = phase_device()
    build_s = phase_build()
    err_a, ka_ms, pa_ms = phase_kernel_vs_plain(dev)
    err_c, kc_ms, pc_ms = phase_k1c_vs_plain(dev)
    err_b, times_b = phase_k1b_vs_plain(dev)
    launch_a, ms_frame, msps = phase_main_path(dev)
    launch_c, ms_frame_c, msps_c = phase_bunny_path(dev)
    phase_golden(dev)
    launch_b = phase_golden_demo(dev)
    kb_ms, pb_ms = times_b["scene_demo (ROLLBACK_TO_ONE + RELATIVE)"]
    log(f"[5] summary: build {build_s:.2f} s; K1a {ka_ms:.4f} ms vs plain "
        f"{pa_ms:.4f} ms per budget-32 march; Cornell {ms_frame:.3f} "
        f"ms/frame, {msps:.4f} Msamples/s; bunny glass {ms_frame_c:.3f} "
        f"ms/frame, {msps_c:.4f} Msamples/s; K1c {kc_ms:.4f} ms vs plain "
        f"{pc_ms:.4f} ms")
    entry = lambda name, line, n, err, k, p: {
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": f"{TPU_KERNEL}:{line}", "launches": n,
        "max_abs_err": err, "ms": k, "plain_ms": p}
    log(json.dumps({"kernels": [
        entry("march_k1a", 297, launch_a, err_a, ka_ms, pa_ms),
        entry("march_k1b", 338, launch_b, err_b, kb_ms, pb_ms),
        entry("march_k1c", 156, launch_c, err_c, kc_ms, pc_ms)]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
