"""The port's bench (``raytracingpbr_tpu_torch/bench.py``, ``bench_torch.py``
and ``tools/bench_*_torch.py``) against the JAX package's on the CPU: the
workload rows equal ``tools/bench_workloads.py``'s, the wavefront
protocol's sample count equals JAX's frames', the fwd+bwd step's gradient
equals ``jax.grad`` of ``bench.py``'s loss, the JSON object has
``bench.py``'s keys and its utilization formula, and without a card every
entry point raises before it prints a result. Small sizes and few frames:
JAX's CPU compiles are the cost.
"""
import ast
import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core.types import make_frame_state as j_make_state
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.models import cornell as jcornell
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import integrator as jinteg
from raytracingpbr_tpu.parallel import train as jtrain
from raytracingpbr_tpu.utils import speedlight as jspeedlight
from raytracingpbr_tpu_torch import bench, convert

from .torch_helpers import CPU, nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source(path):
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read())


def jax_workload_rows():
    """``tools/bench_workloads.py:32-50``'s rows built from the JAX
    models (that script runs its bench when imported), each configuration
    with ``:53``'s 4 steps of one sample."""
    rows = [
        (jcornell.minimal_scene(), jcornell.sky(), jcornell.minimal_camera(),
         jcornell.minimal_config().replace(resolution=(512, 512))),
        (jcornell.full_scene(), jcornell.sky(), jcornell.full_camera(),
         jcornell.full_config()),
        (jdemo.engine_scene(), jdemo.engine_environment(),
         jdemo.engine_camera(), jdemo.engine_config()),
        (jdemo.scene_demo_scene(), jdemo.tokyo_environment(),
         jdemo.engine_camera(), jdemo.tokyo_config()),
        (jbunny.metal_scene(), jbunny.glass_environment(),
         jbunny.camera(3840 / 2160), jbunny.metal_config()),
        (jbunny.glass_scene(), jbunny.glass_environment(),
         jbunny.camera(1920 / 1080), jbunny.glass_config()),
    ]
    return [(s, e, c, f.replace(samples_per_frame=4, samples_per_pixel=1))
            for s, e, c, f in rows]


def jax_row_names():
    """The first element of each tuple ``workloads()`` yields in
    ``tools/bench_workloads.py``, read from its source."""
    fn = next(n for n in ast.walk(_source("tools/bench_workloads.py"))
              if isinstance(n, ast.FunctionDef) and n.name == "workloads")
    return [n.value.elts[0].value for n in ast.walk(fn)
            if isinstance(n, ast.Yield)]


@pytest.mark.parametrize("row", range(6))
def test_workload_rows_match_jax(row):
    """Row by row: the name, letter for letter; every configuration field
    (the resolution among them); the scene's buffers and shapes, the
    sky and the camera against the JAX row's through ``convert``. No
    render."""
    names = jax_row_names()
    assert len(names) == 6
    name, scene, env, cam, cfg = list(bench.workload_rows(CPU))[row]
    assert name == names[row]
    jscene, jenv, jcam, jcfg = jax_workload_rows()[row]
    assert cfg == convert.config_from_jax(jcfg)
    assert cfg.resolution == tuple(jcfg.resolution)
    ref = convert.scene_from_jax(jscene, CPU)
    assert scene.shape_types == ref.shape_types
    assert scene.rot_perm == ref.rot_perm
    got, want = dict(scene.named_buffers()), dict(ref.named_buffers())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(nn(got[k]), nn(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    sky = convert.environment_from_jax(jenv, CPU)
    assert (env.kind, env.bilinear) == (sky.kind, sky.bilinear)
    for k in ("image", "scale", "color_a", "color_b"):
        a, b = getattr(env, k), getattr(sky, k)
        assert (a is None) == (b is None), k
        if a is not None:  # the synthetic HDR map, to an f32 ulp
            torch.testing.assert_close(a, b, rtol=2.4e-7, atol=0)
    jc = convert.camera_from_jax(jcam, CPU)
    for k in ("lookfrom", "lookat", "vup", "vfov", "aspect", "aperture",
              "focus"):
        torch.testing.assert_close(getattr(cam, k), getattr(jc, k), rtol=0,
                                   atol=0)


def test_k1b_paths_are_the_tokyo_and_engine_rows():
    rows = {n: r for n, *r in bench.workload_rows(CPU)}
    paths = bench.k1b_paths(CPU)
    assert list(paths) == ["tokyo 2880x1620", "engine 768x432"]
    for label, name in zip(paths, (bench.ROW_TOKYO, bench.ROW_ENGINE)):
        assert paths[label][3] == rows[name][3]
    assert bench.metal_config() == rows[bench.ROW_METAL][3]
    assert bench.bunny_config() == rows[bench.ROW_GLASS][3]


def test_wavefront_samples_match_jax():
    """``bench.wavefront`` on the headline's Cornell box at 24x24 with one
    first frame, 1 warm-up and 2 timed: the timed frames' samples within
    1% of JAX ``render_frame``'s over the same frames (the lane bar of
    ``tests/test_torch_wavefront.py``), and every count exact in float64."""
    res = (24, 24)
    jcfg = jcornell.full_config().replace(
        samples_per_frame=4, max_raytrace=512, quality_per_sample=0.8,
        resolution=res)
    cfg = bench.headline_config().replace(resolution=res)
    assert cfg == convert.config_from_jax(jcfg)
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    frame = jax.jit(lambda st: jinteg.render_frame(scene, env, cam, st,
                                                   jcfg))
    state, counts = j_make_state(jcfg.num_pixels), []
    for _ in range(4):
        _, state = frame(state)
        counts.append(float(np.asarray(state.accum[:, 3], np.float64).sum()))
    want = counts[3] - counts[1]
    r = bench.wavefront(convert.scene_from_jax(scene, CPU),
                        convert.environment_from_jax(env, CPU),
                        convert.camera_from_jax(cam, CPU), cfg, warmup=1,
                        timed=2)
    assert r["frames"] == 4 and r["samples"] == int(r["samples"]) > 0
    assert abs(r["samples"] - want) <= 0.01 * want, (r["samples"], want)
    assert r["msps"] > 0 and r["launches"]["march"] == dict.fromkeys(
        ("k1a", "k1b", "k1c", "k1d"), 0)


@pytest.fixture
def small_grad_config(monkeypatch):
    """``bench.grad_config`` at 8x8: the fwd+bwd protocol's configuration
    at the tests' size."""
    full = bench.grad_config
    monkeypatch.setattr(bench, "grad_config", lambda *a, **kw: full(
        *a, **kw).replace(resolution=(8, 8)))


def test_fwd_bwd_scan_ad_matches_jax_grad(small_grad_config):
    """``bench.fwd_bwd`` at 8x8 and 2 bounces, one timed step (sample 1):
    the albedo's scan-AD gradient equals ``jax.grad`` of ``bench.py``'s
    loss (``:133-141``) at ``tests/test_torch_gradients.py``'s bar, rtol
    1e-4 with a floor of 1e-5 of the largest entry."""
    r = bench.fwd_bwd(max_raytrace=2, steps=1, device=CPU)
    jcfg = jcornell.full_config().replace(max_raytrace=2, resolution=(8, 8))
    scene, env, cam = (jcornell.full_scene(), jcornell.sky(),
                       jcornell.full_camera())
    n = jcfg.num_pixels
    pid = jnp.arange(n, dtype=jnp.uint32)

    def loss(sc):
        img = jtrain.render_pixels(sc, env, cam, pid, jcfg, spp=1,
                                   sample_offset=jnp.uint32(1),
                                   differentiable=True)
        return jnp.mean((img - jnp.zeros((n, 3))) ** 2)
    want = np.asarray(jax.grad(loss)(scene).albedo, np.float64)
    got = nn(r["grads"]["albedo"]).astype(np.float64)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert r["s"] > 0 and r["msps"] > 0 and r["mem_gib"] is None


@pytest.mark.parametrize("env_sampling", [False, True])
def test_fwd_bwd_replay_runs(small_grad_config, env_sampling):
    """Replay, and replay + NEE under ``bench.sun_sky``'s alias table, at
    8x8 and 2 bounces: the albedo's gradient finite, nonzero and shaped
    as scan-AD's (replay against JAX is ``tests/test_torch_replay.py``'s)."""
    kw = dict(max_raytrace=2, steps=1, device=CPU)
    scan = bench.fwd_bwd(**kw)["grads"]["albedo"]
    r = bench.fwd_bwd(differentiable="replay", env_sampling=env_sampling,
                      **kw)
    g = r["grads"]["albedo"]
    bench.check_grads("replay", r["grads"])
    assert g.shape == scan.shape and g.dtype == scan.dtype


def _bench_keys():
    """``bench.py``'s keys: the ``out`` dict of ``main`` and the extras it
    assigns, in order."""
    main = next(n for n in ast.walk(_source("bench.py"))
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    extras = [n.slice.value for n in ast.walk(main)
              if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
              and isinstance(n.value, ast.Name) and n.value.id == "extras"]
    out = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    return [k.value for k in out.keys if k is not None] + extras


def test_bench_json_has_bench_py_keys():
    """Exactly ``bench.py``'s eleven keys, then ``device``; ``vs_baseline``
    is ``bench.py:231``'s ``value / (5 * CPU_MSPS_REF)`` with its
    constant, and each value keeps ``bench.py``'s rounding."""
    keys = _bench_keys()
    assert len(keys) == 11 and tuple(keys) == bench.KEYS
    ref = next(n.value.value for n in _source("bench.py").body
               if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "CPU_MSPS_REF")
    assert bench.CPU_MSPS_REF == ref
    rates = {"utilization_pct": 12.345, "achieved_gflops": 8012.34,
             "roof_gflops": 65136.61}
    out = bench.bench_json(6.48451234, 1.53961234, (2.9, 0.61234, 0.18123),
                           rates, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert list(out) == keys + ["device"]
    assert out["metric"] == ("cornell_fullpbr_wavefront_megasamples_per_s_"
                             "per_chip") and out["unit"] == "Msamples/s"
    assert out["value"] == 6.4845
    assert out["vs_baseline"] == round(6.48451234 / (5 * ref), 3)
    assert out["fwd_bwd_msps_128bounce_replay_nee"] == 0.1812
    assert out["march_utilization_pct"] == 12.3
    assert out["vpu_roof_gflops"] == 65136.6
    assert out["device"] == {"name": "NVIDIA H100 80GB HBM3",
                             "power_limit": "700.00 W"}
    json.dumps(out)


@pytest.mark.parametrize("fin,dt", [
    ([5, 7, 0, 31, 2] * 300, 0.005), ([512] * 1024 + [3] * 1000, 0.0417)])
def test_executed_rates_follow_jax_speedlight(monkeypatch, fin, dt):
    """From given per-lane trips, JAX's ``march_utilization``
    (``raytracingpbr_tpu/utils/speedlight.py:235-247``, its march, roof and
    clock replaced by those counts) and ``bench.executed_rates`` on the
    same counts give the same executed-work rate and share of the roof."""
    from raytracingpbr_tpu.pallas import march_kernel as jmk

    lanes = np.asarray(fin, np.int32)
    fake = lambda scene, o, d, cfg, active=None: (
        jnp.zeros(o.shape[0]), jnp.zeros(o.shape[0], jnp.int32),
        jnp.zeros(o.shape[0], bool), jnp.asarray(lanes))
    monkeypatch.setattr(jmk, "march_pallas", fake)
    monkeypatch.setattr(jspeedlight, "measure_vpu_peak", lambda: 6.5e13)
    ticks = iter([0.0, dt * 10])
    monkeypatch.setattr(jspeedlight, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks)))
    cfg = jcornell.full_config()
    o = jnp.zeros((lanes.shape[0], 3))
    want = jspeedlight.march_utilization(jcornell.full_scene(), o, o, cfg)
    got = bench.executed_rates({
        "lane_iters_executed": want["lane_iters_executed"],
        "flops_per_iter": want["flops_per_iter"],
        "march_ms": want["march_s"] * 1e3,
        "roof_gflops": want["roof_gflops"]})
    for k in ("utilization_pct", "achieved_gflops", "roof_gflops"):
        assert math.isclose(got[k], want[k], rel_tol=1e-12), k
    assert want["lane_iters_executed"] > want["lane_iters_needed"]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry", ["bench_torch", "bench_workloads_torch",
                                   "bench_nee_torch", "bench_adaptive_torch"])
def test_entry_points_raise_without_a_card(monkeypatch, capsys, entry):
    """With no card each entry point raises before it measures anything
    and prints nothing to stdout: no JSON line, no table."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "bench_torch":
        sys.path.insert(0, REPO)
        try:
            import bench_torch
        finally:
            sys.path.remove(REPO)
        main = bench_torch.main
    else:
        main = lambda: _load_tool(entry).main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main()
    assert capsys.readouterr().out == ""


def test_bench_torch_exits_nonzero_without_a_card():
    """``python3 bench_torch.py`` where no card is visible: a non-zero
    exit and no JSON line on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def test_nee_equal_time_on_the_cpu(monkeypatch):
    """``tools/bench_nee.py``'s protocol at 16x16 with budgets of a second
    or less: every number finite (the truth ran more frames than the NEE
    run, so their images differ), the runs at a positive throughput."""
    monkeypatch.setattr(bench, "NEE_RES", 16)
    out = bench.nee_equal_time(CPU, truth_s=1.0, run_s=(0.02,),
                               diet_s=0.02)
    assert _finite({k: v for k, v in out.items() if k != "launches"})
    run = out["runs"][0]
    assert out["truth_spp"] > run["nee"]["spp"] > 0
    assert run["plain"]["msps"] > 0 and run["nee"]["msps"] > 0
    assert out["diet"]["on"]["msps"] > 0 and out["diet"]["off"]["msps"] > 0
    assert out["launches"]["march"]["k1a"] == 0  # the CPU runs the plain march


def test_adaptive_payoff_on_the_cpu(monkeypatch):
    """``tools/bench_adaptive.py``'s protocol at 16x16 with one early, one
    converging and one late frame: every number finite, the compacted
    frames and the recompaction timed."""
    full = bench.adaptive_config
    monkeypatch.setattr(bench, "adaptive_config", lambda *a: full(
        *a).replace(resolution=(16, 16)))
    out = bench.adaptive_payoff(CPU, early=1, converge=1, late=1)
    assert _finite({k: out[k] for k in (False, True)})
    assert set(out[True]) == {"early_ms", "late_ms", "active",
                              "compacted_late_ms", "recompaction_ms"}
    assert 0 <= out[True]["active"] <= 1 and out[False]["late_ms"] > 0
