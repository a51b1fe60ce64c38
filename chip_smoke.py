#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises and exits non-zero):

0. device: the card's name and power limit, torch / CUDA versions,
   CUDA_HOME, whether triton imports. No card: fail (no CPU fallback).
1. build the CUDA march kernel (K1a) from ``raytracingpbr_tpu_torch/csrc``.
2. kernel vs its plain PyTorch version on the same CUDA tensors at the main
   path's shapes (480x480 Cornell primaries chained in budgets of 32 over
   512 trips; the mixed split-march state after 3 plain wavefront steps; an
   all-inactive gate; a ragged N): all eight outputs bit-equal. Median time
   of each version.
3. the main path: progressive wavefront frames of the full-PBR Cornell box
   (480x480, 4 steps per frame, 512-trip march in budgets of 32, black sky,
   ACES then gamma) as ``bench.py`` times them: 1 + 3 warm-up frames, 10
   timed. The kernel's launch counter must show 4 launches per frame.
4. the ``wavefront_cornell_full`` golden rendered on the card: PSNR >= 35 dB.

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
from raytracingpbr_tpu_torch.models import cornell
from raytracingpbr_tpu_torch.ops import camera, march, scene as scenelib
from raytracingpbr_tpu_torch.ops.integrator import (render_frame,
                                                    render_image_progressive)
from raytracingpbr_tpu_torch.utils.metrics import psnr

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "assets", "goldens", "wavefront_cornell_full.png")
FIELDS = ("t", "index", "hit", "fin", "w", "s", "d", "done")


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
    err = 0.0
    for name, a, b in zip(FIELDS, k, p):
        diff = int((a != b).sum())
        if a.dtype.is_floating_point:
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        if diff:
            raise AssertionError(f"{name}: {diff} of {a.numel()} lanes "
                                 "differ between kernel and plain march")
    return k, err


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


def phase_kernel_vs_plain(dev):
    cfg = main_config()
    scene = cornell.full_scene(dev)
    mcfg = cfg.replace(max_raymarch=cfg.march_split)
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    u = rng.uniform4(pid, 0, 1, cfg.seed)
    uv = camera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = camera.get_ray(cornell.full_camera(dev), uv, u[2], u[3])
    o, d = rays.origin, rays.direction
    err = 0.0

    # primaries, budget 32 chained over the 512-trip budget
    live = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    init, calls = None, 0
    for _ in range(cfg.max_raymarch // cfg.march_split):
        k, e = compare(scene, o, d, mcfg, active=live, init=init)
        err, calls = max(err, e), calls + 1
        live = live & (k.done == 0)
        init = (k.t, k.w, k.s, k.d)
        if not bool(live.any()):
            break
    log(f"[2] primaries: {calls} chained budget-32 calls bit-equal; "
        f"{int(live.sum())} lanes unconverged after 512 trips")

    # mixed split-march state after 3 plain wavefront steps (on the CPU)
    t0 = time.perf_counter()
    st = make_frame_state(cfg.num_pixels)
    _, st = render_frame(cornell.full_scene(), cornell.sky(),
                         cornell.full_camera(), st,
                         cfg.replace(samples_per_frame=3))
    marching = (st.march_cum > 0).to(dev)
    ms = st.march_state.to(dev)
    dflt = (cfg.march_t0, cfg.omega, 0.0, scenelib.MAX_DIS)
    minit = tuple(torch.where(marching, ms[:, j], torch.full_like(ms[:, j], v))
                  for j, v in enumerate(dflt))
    mo, md = st.rays.origin.to(dev), st.rays.direction.to(dev)
    _, e = compare(scene, mo, md, mcfg, init=minit)
    err = max(err, e)
    log(f"[2] mixed state ({int(marching.sum())} segments in flight, "
        f"{time.perf_counter() - t0:.1f} s of CPU steps): bit-equal")

    # all-inactive gate, ragged N
    k, e = compare(scene, o, d, mcfg, active=torch.zeros_like(live))
    assert int(k.fin.sum()) == 0 and bool((k.done == 1).all())
    err = max(err, e)
    _, e = compare(scene, torch.cat([o, o[:1]]), torch.cat([d, d[:1]]), mcfg)
    err = max(err, e)
    log("[2] all-inactive gate and ragged N=230401: bit-equal")

    # time each version on the fresh budget-32 primary march, in turns
    run_k = lambda: march_kernel.march_resumable_cuda(scene, o, d, mcfg)
    run_p = lambda: march.march_resumable_plain(scene, o, d, mcfg)
    run_k(), run_p()
    kms = [median_ms(run_k), median_ms(run_p), median_ms(run_p),
           median_ms(run_k)]
    k_ms, p_ms = (kms[0] + kms[3]) / 2, (kms[1] + kms[2]) / 2
    log(f"[2] budget-32 march at {o.shape[0]} lanes: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms (medians, in turns k p p k: "
        f"{', '.join(f'{v:.4f}' for v in kms)})")
    return err, k_ms, p_ms


def phase_main_path(dev):
    cfg = main_config()
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    state = make_frame_state(cfg.num_pixels, device=dev)
    steps = cfg.samples_per_frame * cfg.samples_per_pixel
    march_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    log(f"[3] first frame: {time.perf_counter() - t0:.2f} s")
    for _ in range(3):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    c0 = float(state.accum[:, 3].sum())
    before = march_kernel.LAUNCHES
    frames = 10
    t0 = time.perf_counter()
    for _ in range(frames):
        px, state = render_frame(scene, env, cam, state, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c1 = float(state.accum[:, 3].sum())
    launches = march_kernel.LAUNCHES
    if launches - before != steps * frames or launches != steps * 14:
        raise AssertionError(f"expected {steps} kernel launches per frame, "
                             f"got {launches} over 14 frames")
    if not c1 > c0 > 0:
        raise AssertionError(f"accumulator alpha did not grow: {c0} -> {c1}")
    if not (bool(torch.isfinite(px).all()) and float(px.min()) >= 0.0
            and float(px.max()) <= 1.0):
        raise AssertionError("pixels not finite in [0, 1]")
    msps = (c1 - c0) / dt / 1e6
    log(f"[3] main path 480x480: {dt / frames * 1e3:.3f} ms/frame, "
        f"{msps:.4f} Msamples/s, {launches} kernel launches in 14 frames")
    return launches, dt / frames * 1e3, msps


def phase_golden(dev):
    cfg = cornell.full_config().replace(resolution=(64, 64),
                                        max_raymarch=160, max_raytrace=12)
    before = march_kernel.LAUNCHES
    img, state = render_image_progressive(
        cornell.full_scene(dev), cornell.sky(dev), cornell.full_camera(dev),
        cfg, spp=8, exposure=0.6)
    assert march_kernel.LAUNCHES > before
    got = (np.clip(img.cpu().numpy(), 0, 1) * 255 + 0.5).astype(np.uint8)
    gold = read_png(GOLDEN)[..., :3]
    db = psnr(got, gold)
    log(f"[4] wavefront_cornell_full golden on the card: {db:.2f} dB "
        f"({int(state.frame)} frames)")
    if not db >= 35.0:
        raise AssertionError(f"golden PSNR {db:.2f} dB < 35")


def main():
    dev = phase_device()
    build_s = phase_build()
    err, k_ms, p_ms = phase_kernel_vs_plain(dev)
    launches, ms_frame, msps = phase_main_path(dev)
    phase_golden(dev)
    log(f"[5] summary: build {build_s:.2f} s, kernel {k_ms:.4f} ms vs plain "
        f"{p_ms:.4f} ms per budget-32 march, {ms_frame:.3f} ms/frame, "
        f"{msps:.4f} Msamples/s")
    log(json.dumps({"kernels": [{
        "name": "march_k1a", "route": "cuda",
        "source": "raytracingpbr_tpu_torch/csrc/march.cu",
        "replaces": "raytracingpbr_tpu/pallas/march_kernel.py:297",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms}]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
