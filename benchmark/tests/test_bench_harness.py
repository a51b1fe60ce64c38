"""The benchmark's harness on the CPU: what it loads, how its cells
resolve by name, and that it refuses to run without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingpbr_tpu")


def _spec():
    return harness.load_json(REPO / "BENCHMARK.json")


def test_nothing_of_jax_is_loaded():
    """run.py and every config, traffic kind, metric and reference module
    of the benchmark, with the program they call, load no module whose
    top-level name (compared whole) is JAX's or the JAX package's."""
    code = (
        "import sys, glob, runpy, importlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import benchmark.run, benchmark.harness, benchmark.calibrate\n"
        "import benchmark.reference.scene, benchmark.reference.march\n"
        "import benchmark.reference.render, benchmark.metrics.work\n"
        "from benchmark import trace, program, harness, reference\n"
        "program.port()\n"
        "for f in sorted(glob.glob('benchmark/kinds/*.py')):\n"
        "    if not f.endswith('__init__.py'):\n"
        "        harness.load_kind(f.split('/')[-1][:-3])\n"
        "for f in sorted(glob.glob('benchmark/reference/*/*.py')):\n"
        "    g, n = f.split('/')[-2:]\n"
        "    if n != '__init__.py':\n"
        "        reference.part(g, n[:-3])\n"
        "for f in sorted(glob.glob('benchmark/metrics/*.*.py')):\n"
        "    trace.load_reader(f)\n"
        "import json\n"
        "for f in glob.glob('benchmark/configs/*.json') + "
        "glob.glob('benchmark/traffic/*.json'):\n"
        "    json.load(open(f))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "raytracingpbr_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_run_forbidden_modules_compares_whole_names(monkeypatch):
    """``run.forbidden_modules`` flags the JAX package by its whole
    top-level name and not the port, whose name begins with it."""
    from benchmark import run
    import raytracingpbr_tpu_torch  # noqa: F401
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raytracingpbr_tpu.ops", sys)
    assert run.forbidden_modules() == ["raytracingpbr_tpu"]


def test_every_cell_resolves_to_its_files():
    spec = _spec()
    metrics = {m["name"] for m in spec["per_layer"]}
    for w in spec["workloads"]:
        cell = harness.resolve(spec, w["name"])
        kind = harness.load_kind(cell.kind)
        for f in ("setup", "unit", "metrics", "replay", "compare",
                  "control"):
            assert callable(getattr(kind, f)), (cell.kind, f)
        assert (REPO / "benchmark" / "traffic"
                / f"{w['traffic']}.json").exists()
        # the reference's parts that the configuration names are there
        rs, sky, cam, rc = harness.reference_side(cell, 1, "cpu")
        assert rs.bucket_shapes and rc["features"] == tuple(
            cell.config["reference_features"])
        assert cell.limits, f"{w['name']} has no limits file"
        assert cell.end_to_end and cell.per_layer
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        if cell.config.get("weights"):
            assert cell.mlp_path().exists()
    for name in metrics:
        assert harness.reader_path(name)
    for m in spec["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in spec["workloads"]}
    for c in spec["configs"]:
        data = harness.load_json(REPO / c["file"])
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_run_exits_without_a_card():
    """With no card visible, run.py exits non-zero and prints no JSON."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cornell_full.frames", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    last = (out.stdout.strip().splitlines() or [""])[-1]
    assert not last.startswith("{")


def test_grad_compared_wants_nan_where_the_reference_has_nan():
    """An entry that is not finite has to be so on both sides, alike (the
    sky's ``asin`` at a pole makes a step's MLP gradient NaN, PERF.md §7):
    the finite entries are compared; any other program value there, or a
    NaN where the reference is finite, reads infinity; the loss alike."""
    import math
    import torch
    from benchmark.kinds.grad import grad_compared
    nan, inf = float("nan"), float("inf")
    ref = {"a": torch.tensor([1.0, nan, 2.0, inf]),
           "b": torch.tensor([3.0, 4.0])}
    same = {"a": torch.tensor([1.0, nan, 2.0, inf]),
            "b": torch.tensor([3.0, 4.0])}
    assert grad_compared(1.0, same, 1.0, ref) == {"loss_gap": 0.0,
                                                  "grad_gap": 0.0}
    for a in ([1.0, 5.0, 2.0, inf], [1.0, nan, nan, inf],
              [1.0, nan, 2.0, -inf], [1.0, nan, 2.0, nan]):
        got = {"a": torch.tensor(a), "b": torch.tensor([3.0, 4.0])}
        assert math.isinf(grad_compared(1.0, got, 1.0, ref)["grad_gap"]), a
    assert grad_compared(nan, same, nan, ref)["loss_gap"] == 0.0
    assert math.isinf(grad_compared(1.0, same, nan, ref)["loss_gap"])
    assert math.isinf(grad_compared(nan, same, 1.0, ref)["loss_gap"])
    off = {"a": torch.tensor([1.0, nan, 2.0, inf]),
           "b": torch.tensor([3.0, 4.5])}
    got = grad_compared(1.1, off, 1.0, ref)
    assert abs(got["grad_gap"] - 0.1) < 1e-12
    assert abs(got["loss_gap"] - 0.1) < 1e-12


def test_parts_and_kinds_are_found_by_name():
    """A configuration's shape, sky, omega policy, hit test and features,
    and a traffic's kind, are files found by name: one that is not there
    is refused with the file to add; a render setting beyond the plain
    path is refused unless a feature of its name is listed."""
    import pytest
    from benchmark import reference
    from benchmark.reference import render
    assert reference.part("shapes", "bunny").ID == 6
    for group, name in (("shapes", "cylinder"), ("sky", "sun"),
                        ("omega", "rollback_half_up"), ("hit", "cone"),
                        ("features", "env_sampling"), ("sky", "../march")):
        with pytest.raises(ValueError, match="reference/" + group):
            reference.part(group, name)
    with pytest.raises(ValueError, match="kinds/offline.py"):
        harness.load_kind("offline")
    plain = {"resolution": [4, 4], "env_sampling": True}
    with pytest.raises(ValueError, match="env_sampling"):
        render.settings(plain, 1)
    with pytest.raises(ValueError, match="features/env_sampling.py"):
        render.settings(plain, 1, ["env_sampling"])


def test_stage_takes_a_features_replacement(monkeypatch):
    """A feature module's function of a stage's name runs in the base's
    place, for the settings that list the feature."""
    import types
    from benchmark import reference
    mod = types.SimpleNamespace(render_frame=lambda *a: "feature")
    real = reference.part
    monkeypatch.setattr(reference, "part", lambda g, n: mod
                        if (g, n) == ("features", "fake") else real(g, n))
    from benchmark.reference import render
    rc = {"features": ("fake",)}
    assert render.render_frame(None, None, None, {}, 0, None, rc) \
        == "feature"
    assert reference.stage(rc, "march") is reference.BASE["march"]
    assert reference.stage({}, "render_frame") \
        is reference.BASE["render_frame"]


def test_metric_names_with_a_qualifier_read_as_their_base():
    assert harness.by_name({"step_ms": 3.0}, "step_ms.host_bound") == 3.0
    assert harness.by_name({"step_ms": 3.0}, "steps") is None
    assert harness.reader_path("launches.step.device_bound").endswith(
        "metrics/launches.step.py")
    assert harness.reader_path("launches.frame").endswith(
        "metrics/launches.frame.py")
