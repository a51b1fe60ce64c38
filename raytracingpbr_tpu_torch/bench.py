"""The bench's protocols, as plain functions: the port of the repo root's
``bench.py`` (the Cornell full-PBR wavefront headline and its five
extras) and of ``tools/bench_workloads.py``, ``tools/bench_nee.py`` and
``tools/bench_adaptive.py``. This module is the one home of each protocol:
``bench_torch.py``, ``tools/bench_*_torch.py`` and ``chip_smoke.py`` call
these functions and time nothing of their own.

Every protocol runs on the card unless given ``device="cpu"`` (the tests
do) and returns a dict. A window timed on the card ends in
``torch.cuda.synchronize()``. The first call of a process builds the
kernels (``kernels/build.py``); each protocol makes that call outside its
timed window. Sample counts are summed in float64: a float32 sum stops
counting exactly above 2**24. The kernels' launch counts
(``kernels/march_kernel.LAUNCHES`` and ``BOUND_LAUNCHES``,
``kernels/fma_kernel.LAUNCHES``, ``kernels/rng_kernel.LAUNCHES``) are set to 0 where a protocol's counted
run starts and read where it ends. On the CPU the plain march runs and
nothing is launched.
"""
from __future__ import annotations

import math
import subprocess
import sys
import time

import numpy as np
import torch

from .config import HitCriterion, OmegaPolicy, RenderConfig
from .core import rng
from .core.device import resolve
from .core.types import make_camera, make_frame_state
from .kernels import fma_kernel, march_kernel, rng_kernel
from .models import bunny, cornell, demo
from .ops import camera, ibl
from .ops import compact as compactlib
from .ops.integrator import render_frame, render_frame_tile, render_image
from .ops.scene import ObjectSpec, make_scene
from .ops.sdf import SHAPE
from .parallel import train as ptrain
from .utils import speedlight
from .utils.metrics import psnr

# bench.py:34: BASELINE.json's bar is 5x CPU-Taichi samples/s; Taichi was
# not installable, so bench.py's stand-in is the JAX package's own
# wavefront on a CPU host (480x480 Cornell, 0.0073 Msamples/s). Neither a
# TPU nor a GPU number.
CPU_MSPS_REF = 0.0073
METRIC = "cornell_fullpbr_wavefront_megasamples_per_s_per_chip"
# bench.py's keys, in its order
KEYS = ("metric", "value", "unit", "vs_baseline", "megakernel_fwd_msps",
        "fwd_bwd_msps_8bounce", "fwd_bwd_msps_128bounce_replay",
        "fwd_bwd_msps_128bounce_replay_nee", "march_utilization_pct",
        "march_achieved_gflops", "vpu_roof_gflops")
# the workload table's frames: 4 wavefront steps of one sample each
WORKLOAD_STEPS = dict(samples_per_frame=4, samples_per_pixel=1)
# tools/bench_workloads.py:32-50's row names, letter for letter
ROW_MINIMAL = "cornell minimal 512x512 (3 bounce/256 march)"
ROW_FULL = "cornell full-PBR 480x480 (128/512)"
ROW_ENGINE = "engine default 768x432 (512/512)"
ROW_TOKYO = "tokyo IBL 2880x1620 (512/512)"
ROW_METAL = "bunny metal 4K 3840x2160 (128/512)"
ROW_GLASS = "bunny glass 1920x1080 (512/2048)"
ROWS = (ROW_MINIMAL, ROW_FULL, ROW_ENGINE, ROW_TOKYO, ROW_METAL, ROW_GLASS)
# tools/bench_nee.py's wall-time budgets (seconds) and
# tools/bench_adaptive.py's frame counts: the protocols' defaults
NEE_BUDGETS = dict(truth_s=60.0, run_s=(3.0, 10.0), diet_s=30.0)
# tools/bench_nee.py:30's image side (W = H)
NEE_RES = 160
ADAPTIVE_FRAMES = dict(early=10, converge=120, late=10)
# the prefix of the one stderr line on which an entry point prints its
# run's record (launch counts and the numbers behind its output) as JSON
RECORD = "record "


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_launches() -> None:
    march_kernel.reset_launches()
    fma_kernel.reset_launches()
    rng_kernel.reset_launches()


def launches() -> dict:
    """The launch counts since :func:`reset_launches`: each march kernel's,
    its escape-bound (shadow-ray) share, K2's and the RNG kernel's."""
    return {"march": dict(march_kernel.LAUNCHES),
            "bound": dict(march_kernel.BOUND_LAUNCHES),
            "k2": fma_kernel.LAUNCHES["k2"],
            "rng": dict(rng_kernel.LAUNCHES)}


def sample_count(state) -> float:
    """Completed samples in a frame state, summed in float64."""
    return float(state.accum[:, 3].double().sum())


# --- configurations ----------------------------------------------------------


def headline_config() -> RenderConfig:
    """bench.py:60-62: the Cornell full-PBR box, 4 steps a frame, a
    512-bounce budget."""
    return cornell.full_config().replace(samples_per_frame=4,
                                         max_raytrace=512,
                                         quality_per_sample=0.8)


def bunny_config() -> RenderConfig:
    """The glass bunny row's configuration: 1920x1080, 4 steps a frame of
    one sample each."""
    return bunny.glass_config().replace(**WORKLOAD_STEPS)


def metal_config() -> RenderConfig:
    """The metal bunny row's configuration: 3840x2160, 4 steps a frame of
    one sample each."""
    return bunny.metal_config().replace(**WORKLOAD_STEPS)


def workload_rows(device=None, names=None):
    """``tools/bench_workloads.py:32-50``'s six rows in its order, each
    ``(name, scene, environment, camera, config)`` with the configuration
    at 4 steps a frame of one sample (``:53``); ``names``: only those
    rows. Each row is built when it is reached."""
    dev = resolve(device)
    rows = {
        ROW_MINIMAL: lambda: (
            cornell.minimal_scene(dev), cornell.sky(dev),
            cornell.minimal_camera(dev),
            cornell.minimal_config().replace(resolution=(512, 512))),
        ROW_FULL: lambda: (
            cornell.full_scene(dev), cornell.sky(dev),
            cornell.full_camera(dev), cornell.full_config()),
        ROW_ENGINE: lambda: (
            demo.engine_scene(dev), demo.engine_environment(device=dev),
            demo.engine_camera(dev), demo.engine_config()),
        ROW_TOKYO: lambda: (
            demo.scene_demo_scene(dev), demo.tokyo_environment(device=dev),
            demo.engine_camera(dev), demo.tokyo_config()),
        ROW_METAL: lambda: (
            bunny.metal_scene(dev), bunny.glass_environment(device=dev),
            bunny.camera(3840 / 2160, dev), bunny.metal_config()),
        ROW_GLASS: lambda: (
            bunny.glass_scene(dev), bunny.glass_environment(device=dev),
            bunny.camera(1920 / 1080, dev), bunny.glass_config()),
    }
    for name in ROWS:
        if names is None or name in names:
            make = rows[name]
            scene, env, cam, cfg = make()
            yield name, scene, env, cam, cfg.replace(**WORKLOAD_STEPS)


def k1b_paths(device=None) -> dict:
    """K1b's two rows, tokyo then engine: {label: (scene, environment,
    camera, config)}."""
    rows = {name: rest for name, *rest in workload_rows(
        device, (ROW_TOKYO, ROW_ENGINE))}
    return {"tokyo 2880x1620": tuple(rows[ROW_TOKYO]),
            "engine 768x432": tuple(rows[ROW_ENGINE])}


def sun_sky(device=None):
    """bench.py:122-128's sky for the NEE extra: 64x32 texels of 0.05
    with a 4x4 sun of 25, unbaked."""
    img = np.full((64, 32, 3), 0.05, np.float32)
    img[40:44, 24:28] = 25.0
    return ibl.hdr_environment(img, prebake=False, device=device)


def grad_config(max_raytrace: int, env_sampling: bool = False,
                **kw) -> RenderConfig:
    """bench.py:116's fwd+bwd configuration: the Cornell full box with
    ``max_raytrace`` bounces (``kw``: more fields, such as replay's
    march checkpoint)."""
    return cornell.full_config().replace(max_raytrace=max_raytrace,
                                         env_sampling=env_sampling, **kw)


# --- the wavefront frames (the headline and the workload rows) ---------------


def wavefront(scene, env, cam, cfg, warmup: int = 3, timed: int = 10):
    """bench.py:53-85 from a fresh state: one first frame (the kernels'
    build at a process's first call) timed apart, ``warmup`` frames, then
    ``timed`` frames ending in a sync; samples = the growth of
    ``accum[:, 3]``'s sum over the timed frames. The launch counts cover
    every frame. Returns first_s, ms (a frame), msps, samples, frames,
    launches, and the last pixels and state."""
    dev = scene.device
    state = make_frame_state(cfg.num_pixels, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    px, state = render_frame(scene, env, cam, state, cfg)
    _sync(dev)
    first = time.perf_counter() - t0
    for _ in range(warmup):
        px, state = render_frame(scene, env, cam, state, cfg)
    _sync(dev)
    c0 = sample_count(state)
    t0 = time.perf_counter()
    for _ in range(timed):
        px, state = render_frame(scene, env, cam, state, cfg)
    _sync(dev)
    dt = time.perf_counter() - t0
    samples = sample_count(state) - c0
    return dict(first_s=first, ms=dt / timed * 1e3, msps=samples / dt / 1e6,
                samples=samples, frames=1 + warmup + timed,
                launches=launches(), pixels=px, state=state)


def check_frame_launches(label: str, out: dict, cfg, kind: str,
                         per_step: int = 1) -> None:
    """On the card, a wavefront run (:func:`wavefront`) must launch
    ``kind``'s kernel ``per_step`` times a step (2 with NEE: the bounce
    and the shadow rays, whose launches are the escape-bound ones) and no
    other march kernel: there is no plain march on the card. Raises
    RuntimeError."""
    steps = cfg.samples_per_frame * cfg.samples_per_pixel * out["frames"]
    got = out["launches"]
    want = {k: per_step * steps if k == kind else 0 for k in got["march"]}
    bound = {k: (per_step - 1) * steps if k == kind else 0
             for k in got["bound"]}
    if got["march"] != want or got["bound"] != bound:
        raise RuntimeError(
            f"{label}: expected {per_step * steps} {kind} launches over "
            f"{out['frames']} frames ({bound[kind]} escape-bound), got "
            f"{got['march']} ({got['bound']} escape-bound)")


def check_kinds(label: str, got: dict, kinds) -> None:
    """Each of ``kinds`` launched and no other march kernel (``got``:
    :func:`launches`). Raises RuntimeError."""
    march = got["march"]
    if not all(march[k] for k in kinds) or any(
            v for k, v in march.items() if k not in kinds):
        raise RuntimeError(f"{label}: expected {tuple(kinds)} launches "
                           f"alone, got {march}")


def workloads(device=None, warmup: int = 2, timed: int = 5) -> list:
    """``tools/bench_workloads.py:52-77``: each row of
    :func:`workload_rows` at its native resolution, one first frame, 2
    warm-up and 5 timed; on the card each row's kernel 4 launches a frame
    and no other. Returns one dict a row."""
    out = []
    for name, scene, env, cam, cfg in workload_rows(device):
        r = wavefront(scene, env, cam, cfg, warmup, timed)
        kind = march_kernel.variant(scene, cfg)
        if scene.device.type == "cuda":
            check_frame_launches(name, r, cfg, kind)
        log(f"{name}: {r['msps']:.3f} Msamples/s, {r['ms']:.1f} ms/frame "
            f"(first frame {r['first_s']:.1f} s), {r['samples']:.0f} "
            f"samples, {r['launches']['march'][kind]} {kind} launches in "
            f"{r['frames']} frames")
        out.append(dict(name=name, resolution=list(cfg.resolution),
                        kind=kind, **{k: r[k] for k in (
                            "msps", "ms", "first_s", "samples", "frames",
                            "launches")}))
    return out


def workloads_table(rows) -> str:
    """``tools/bench_workloads.py:78-81``'s markdown table."""
    lines = ["| workload | Msamples/s/GPU | ms/frame (4 steps) |",
             "|---|---|---|"]
    lines += [f"| {r['name']} | {r['msps']:.2f} | {r['ms']:.0f} |"
              for r in rows]
    return "\n".join(lines)


# --- the megakernel, the gradient steps, the utilization ---------------------


def megakernel(scene, env, cam, cfg, passes: int = 6, first: int = 1,
               warm: bool = True, **kw) -> dict:
    """bench.py:88-108: ``render_image(spp=1, tonemapped=False)`` at
    sample offset ``first - 1`` as the warm-up (unless ``warm`` is
    False), then ``passes`` passes at offsets ``first, first + 1, ...``
    ending in a sync. ``kw`` go to ``render_image``. Returns warm_s, ms (a
    pass), msps (pixels over a pass's seconds), launches, mem_gib (the
    passes' peak on the card) and the last image."""
    dev = scene.device
    run = lambda s: render_image(scene, env, cam, cfg, spp=1,
                                 sample_offset=s, tonemapped=False, **kw)
    t0 = time.perf_counter()
    if warm:
        run(first - 1)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for s in range(first, first + passes):
        img = run(s)
    _sync(dev)
    dt = (time.perf_counter() - t0) / passes
    mem = (torch.cuda.max_memory_allocated(dev) / 2**30
           if dev.type == "cuda" else None)
    return dict(warm_s=warm_s, ms=dt * 1e3, msps=cfg.num_pixels / dt / 1e6,
                launches=launches(), mem_gib=mem, img=img)


def albedo_grad(scene, env, cam, cfg, differentiable, s, target=None):
    """One fwd+bwd step of bench.py:137-141: ``render_pixels`` of every
    pixel at spp 1 and sample offset ``s``, the mean squared difference
    from ``target`` (zeros), the gradient of ``albedo`` alone
    (``differentiable``: True scan-AD, ``"replay"`` path replay)."""
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                       device=scene.device)
    albedo = scene.albedo.clone().requires_grad_(True)
    img = ptrain.render_pixels(scene.replace(albedo=albedo), env, cam, pid,
                               cfg, spp=1, sample_offset=s,
                               differentiable=differentiable)
    target = torch.zeros_like(img) if target is None else target
    (g,) = torch.autograd.grad(torch.mean((img - target) ** 2), albedo)
    return g


def timed_steps(step, steps: int, device) -> dict:
    """bench.py:143-151: ``step(0)`` as the warm-up, then ``step(1..
    steps)`` ending in a sync. ``step(s)`` returns {name: gradient}.
    Returns warm_s, s (a step), launches, held_gib and mem_gib (on the
    card: what was allocated before the steps, and their peak above it)
    and the last gradients."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    step(0)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    held = None
    if dev.type == "cuda":
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for s in range(1, steps + 1):
        grads = step(s)
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    mem = (None if held is None
           else (torch.cuda.max_memory_allocated(dev) - held) / 2**30)
    return dict(warm_s=warm_s, s=dt, launches=launches(),
                held_gib=None if held is None else held / 2**30, mem_gib=mem,
                grads=grads)


def check_positive(label: str, values: dict) -> None:
    """Each value a finite number above 0. Raises RuntimeError."""
    bad = {k: v for k, v in values.items()
           if not (isinstance(v, (int, float)) and math.isfinite(v)
                   and v > 0)}
    if bad:
        raise RuntimeError(f"{label}: not finite and above 0: {bad}")


def check_grads(label: str, grads: dict) -> None:
    """Each gradient finite and nonzero. Raises RuntimeError."""
    for name, g in grads.items():
        if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
            raise RuntimeError(f"{label}: the {name} gradient is not finite "
                               f"and nonzero: {g.tolist()}")


def grad_setup(max_raytrace: int = 8, env_sampling: bool = False,
               device=None):
    """bench.py:113-128: the Cornell full box with ``max_raytrace``
    bounces, under its black sky, or with NEE under :func:`sun_sky` and
    its alias table. Returns (scene, environment, camera, config)."""
    dev = resolve(device)
    env = (ibl.with_env_sampler(sun_sky(dev)) if env_sampling
           else cornell.sky(dev))
    return (cornell.full_scene(dev), env, cornell.full_camera(dev),
            grad_config(max_raytrace, env_sampling))


def fwd_bwd(max_raytrace: int = 8, differentiable=True,
            env_sampling: bool = False, steps: int = 4,
            device=None) -> dict:
    """bench.py:110-152: :func:`timed_steps` of :func:`albedo_grad` on
    :func:`grad_setup`'s scene; msps is pixels over a step's seconds."""
    scene, env, cam, cfg = grad_setup(max_raytrace, env_sampling, device)
    out = timed_steps(lambda s: {"albedo": albedo_grad(
        scene, env, cam, cfg, differentiable, s)}, steps, scene.device)
    out["msps"] = cfg.num_pixels / out["s"] / 1e6
    return out


def utilization_rays(cfg, cam):
    """bench.py:163-168's rays: ``uniform4(pid, 0, 1, seed)``, then
    ``pixel_uv`` and ``get_ray``. Returns (origin, direction)."""
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                       device=cam.lookfrom.device)
    u = rng.uniform4(pid, 0, 1, cfg.seed)
    uv = camera.pixel_uv(pid, cfg.width, cfg.height, u[0], u[1])
    rays = camera.get_ray(cam, uv, u[2], u[3])
    return rays.origin, rays.direction


def executed_rates(stats: dict) -> dict:
    """bench.py's utilization keys in the JAX package's meaning
    (``raytracingpbr_tpu/utils/speedlight.py:235-247``): the EXECUTED
    lane-trips times the flops a trip over the march's time, and that
    rate's share of the measured roof. ``stats``: the port's
    ``march_utilization`` (whose own ``utilization_pct`` and
    ``achieved_gflops`` are the needed work's rate)."""
    achieved = (stats["lane_iters_executed"] * stats["flops_per_iter"]
                / (stats["march_ms"] / 1e3))
    return {"utilization_pct": 100.0 * achieved
            / (stats["roof_gflops"] * 1e9),
            "achieved_gflops": achieved / 1e9,
            "roof_gflops": stats["roof_gflops"]}


def utilization(device=None) -> dict:
    """bench.py:154-178: K2's roof (measured once a process) and the
    Cornell full box's 480x480 primaries marched once over 512 trips
    through ``utils/speedlight.march_utilization`` (card only). Returns
    the port's stats, :func:`executed_rates` and the launches."""
    dev = resolve(device)
    cfg = cornell.full_config()
    o, d = utilization_rays(cfg, cornell.full_camera(dev))
    reset_launches()
    stats = speedlight.march_utilization(cornell.full_scene(dev), o, d, cfg)
    return dict(stats=stats, executed=executed_rates(stats),
                launches=launches())


def bench_json(value: float, megakernel_msps: float, fwd_bwd_msps,
               rates: dict, card: str) -> dict:
    """bench.py:227-233's JSON object: its eleven keys with its rounding,
    then ``device`` (the card's name and power limit from ``card``, an
    ``nvidia-smi`` line). ``fwd_bwd_msps``: at 8 bounces, replay at 128,
    replay + NEE at 128; ``rates``: :func:`executed_rates`."""
    name, _, limit = card.rpartition(", ")
    fb8, rep, rep_nee = fwd_bwd_msps
    return {
        "metric": METRIC,
        "value": round(value, 4),
        "unit": "Msamples/s",
        "vs_baseline": round(value / (5 * CPU_MSPS_REF), 3),
        "megakernel_fwd_msps": round(megakernel_msps, 4),
        "fwd_bwd_msps_8bounce": round(fb8, 4),
        "fwd_bwd_msps_128bounce_replay": round(rep, 4),
        "fwd_bwd_msps_128bounce_replay_nee": round(rep_nee, 4),
        "march_utilization_pct": round(rates["utilization_pct"], 1),
        "march_achieved_gflops": round(rates["achieved_gflops"], 1),
        "vpu_roof_gflops": round(rates["roof_gflops"], 1),
        "device": {"name": name, "power_limit": limit},
    }


# --- NEE at equal time, and what adaptive sampling pays ----------------------


def nee_setup(device=None):
    """``tools/bench_nee.py:30-50``: the sun-lit scene (a ground sphere,
    a diffuse and a metal sphere) under :func:`sun_sky` at
    :data:`NEE_RES` squared. Returns (scene, sky, sky with its alias
    table, camera, config)."""
    dev = resolve(device)
    env = sun_sky(dev)
    scene = make_scene([
        ObjectSpec(SHAPE.SPHERE, position=(0, -101, 0), scale=(100,) * 3,
                   albedo=(0.7, 0.7, 0.7), roughness=1.0),
        ObjectSpec(SHAPE.SPHERE, position=(-1.1, 0, 0), scale=(1.0,) * 3,
                   albedo=(0.6, 0.4, 0.3), roughness=1.0),
        ObjectSpec(SHAPE.SPHERE, position=(1.1, 0, 0), scale=(1.0,) * 3,
                   albedo=(0.9, 0.9, 0.9), roughness=0.5, metallic=1.0),
    ], device=dev)
    cam = make_camera(lookfrom=(0, 1.2, 5.0), lookat=(0, 0, 0), vfov=40.0,
                      aspect=1.0, aperture=0.0, focus=1.0, device=dev)
    cfg = RenderConfig(resolution=(NEE_RES, NEE_RES), max_raymarch=64,
                       max_raytrace=64, omega=1.0,
                       omega_policy=OmegaPolicy.CONSTANT,
                       hit_criterion=HitCriterion.ABSOLUTE,
                       hit_precision=1e-4, march_t0=0.005, max_dis=300.0,
                       samples_per_frame=4)
    return scene, env, ibl.with_env_sampler(env), cam, cfg


def nee_equal_time(device=None, truth_s: float = NEE_BUDGETS["truth_s"],
                   run_s=NEE_BUDGETS["run_s"],
                   diet_s: float = NEE_BUDGETS["diet_s"]) -> dict:
    """``tools/bench_nee.py:53-110``: a converged NEE truth (``truth_s``
    seconds of frames), then for each of ``run_s`` seconds the plain and
    the NEE estimator from a fresh state (throughput, mean spp, PSNR of
    the linear image against the truth), then the shadow diet on and off
    for ``diet_s`` each (throughput, and the converged means' largest
    shift). A run: one warm frame outside the budget, then frames each
    ending in a sync until the budget is spent; its Msamples/s counts
    every sample in the state over the loop's seconds, as the JAX
    script's does. Each run renders with its own configuration. Returns
    the numbers and the launches over the whole protocol."""
    scene, env, env_s, cam, cfg = nee_setup(device)
    dev = scene.device

    def run(cfg, env, seconds):
        state = make_frame_state(cfg.num_pixels, device=dev)
        _, state = render_frame(scene, env, cam, state, cfg)
        _sync(dev)  # warm, outside the budget
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            _, state = render_frame(scene, env, cam, state, cfg)
            _sync(dev)
        dt = time.perf_counter() - t0
        alpha = state.accum[:, 3:4]
        lin = (state.accum[:, :3] / torch.clamp(alpha, min=1.0)).cpu()
        return dict(lin=lin.numpy(), msps=sample_count(state) / dt / 1e6,
                    spp=float(alpha.double().mean()))

    nee = cfg.replace(env_sampling=True)
    reset_launches()
    truth = run(nee, env_s, truth_s)
    log(f"truth: NEE {truth['spp']:.0f} spp")
    runs = []
    for seconds in run_s:
        a, b = run(cfg, env, seconds), run(nee, env_s, seconds)
        pa, pb = psnr(a["lin"], truth["lin"]), psnr(b["lin"], truth["lin"])
        log(f"{seconds:.0f}s  plain: {a['msps']:6.2f} Msps {a['spp']:6.0f} "
            f"spp PSNR {pa:5.2f} dB   |   NEE+MIS: {b['msps']:6.2f} Msps "
            f"{b['spp']:6.0f} spp PSNR {pb:5.2f} dB")
        runs.append(dict(seconds=seconds, plain=dict(
            msps=a["msps"], spp=a["spp"], psnr=pa), nee=dict(
            msps=b["msps"], spp=b["spp"], psnr=pb)))
    on = run(nee, env_s, diet_s)
    off = run(nee.replace(shadow_diet=False), env_s, diet_s)
    shift = float(np.abs(on["lin"].mean(0) - off["lin"].mean(0)).max())
    rel = shift / float(off["lin"].mean() + 1e-9)
    log(f"shadow diet ON : {on['msps']:6.2f} Msps ({on['spp']:.0f} spp)")
    log(f"shadow diet OFF: {off['msps']:6.2f} Msps ({off['spp']:.0f} spp)")
    log(f"diet mean shift: {shift:.2e} abs ({rel * 100:.3f}% of mean) "
        f"[converged means over {on['spp']:.0f}/{off['spp']:.0f} spp]")
    return dict(truth_spp=truth["spp"], runs=runs, diet=dict(
        on=dict(msps=on["msps"], spp=on["spp"]),
        off=dict(msps=off["msps"], spp=off["spp"]), shift=shift, rel=rel),
        launches=launches())


def adaptive_config(adaptive: bool, threshold: float) -> RenderConfig:
    """``tools/bench_adaptive.py``'s frames: the Cornell full box, 4 steps
    a frame, adaptive sampling on or off at ``threshold``."""
    return cornell.full_config().replace(
        samples_per_frame=4, quality_per_sample=0.8,
        adaptive_sampling=adaptive, noise_threshold=threshold)


def adaptive_payoff(device=None, early: int = ADAPTIVE_FRAMES["early"],
                    converge: int = ADAPTIVE_FRAMES["converge"],
                    late: int = ADAPTIVE_FRAMES["late"],
                    threshold: float = 1e-2) -> dict:
    """``tools/bench_adaptive.py:21-74`` on the Cornell full box (4 steps
    a frame), adaptive sampling off and then on at ``threshold``: ms a
    frame over ``early`` frames, then after ``converge`` more over
    ``late`` frames, and the share of pixels still active; with adaptive
    sampling also the frames over the state compacted actives-first
    (``ops/compact``, ``render_frame_tile``) and one recompaction's ms.
    Returns {False: ..., True:
    ...} and the launches over the whole protocol."""
    dev = resolve(device)
    scene, env, cam = (cornell.full_scene(dev), cornell.sky(dev),
                       cornell.full_camera(dev))
    out = {}
    reset_launches()
    for adaptive in (False, True):
        cfg = adaptive_config(adaptive, threshold)
        frame = lambda st: render_frame(scene, env, cam, st, cfg)
        _, st = frame(make_frame_state(cfg.num_pixels, device=dev))
        _sync(dev)

        def timed(fn, state, n):
            t0 = time.perf_counter()
            for _ in range(n):
                _, state = fn(state)
            _sync(dev)
            return (time.perf_counter() - t0) / n * 1e3, state

        early_ms, st = timed(frame, st, early)
        for _ in range(converge):  # let the noise metric converge pixels
            _, st = frame(st)
        _sync(dev)
        late_ms, st = timed(frame, st, late)
        act = float((st.noise > cfg.noise_threshold).double().mean())
        log(f"adaptive={adaptive}: early {early_ms:.1f} ms/frame, late "
            f"{late_ms:.1f} ms/frame ({act * 100:.0f}% pixels active)")
        row = dict(early_ms=early_ms, late_ms=late_ms, active=act)
        if adaptive:
            pid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                               device=dev)
            stc, pid = compactlib.compact_frame_state(st, pid, threshold)
            tile = lambda s: render_frame_tile(scene, env, cam, s, cfg, pid)
            _, stc = tile(stc)
            _sync(dev)
            row["compacted_late_ms"], stc = timed(tile, stc, late)
            t0 = time.perf_counter()
            stc, pid = compactlib.compact_frame_state(stc, pid, threshold)
            _sync(dev)
            row["recompaction_ms"] = (time.perf_counter() - t0) * 1e3
            log(f"  compacted: late {row['compacted_late_ms']:.1f} ms/frame "
                f"(recompaction itself {row['recompaction_ms']:.1f} ms)")
        out[adaptive] = row
    out["launches"] = launches()
    return out
