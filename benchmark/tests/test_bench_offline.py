"""The offline traffic on the CPU at a small size with a cut march budget:
the program's sample pass (``render_image`` at one sample, through the
forward ``megakernel_trace``) against the reference's forward megakernel
bit for bit, in colour and bounce count, on the shipped weights and on
seeded noisy ones; the reference's forward stage killing a below-surface
reflection where the base stage folds it back; the harness's judgement of
a sound run and of broken ones; the bfloat16 control coming out not
correct; and ``tail_ms.pass`` on a hand-made trace. The TF32 control needs
the card (``benchmark/calibrate.py``)."""
import time
import types

import pytest
import torch

from benchmark import harness, program
from benchmark import trace as tracelib
from benchmark.kinds import offline
from benchmark.reference import render as ref
from benchmark.reference import stage

from helpers import small_cell

SIZE = (48, 27)
CUT = {"max_raymarch": 64, "max_raytrace": 16}
NOISE_SEED = 20261
SEED = 2**32 + 4_000_037


def _cell(size=SIZE, **render):
    cell = small_cell("bunny_glass.offline", size=size)
    cell.config["render"].update(CUT, **render)
    return cell


def _noised(mlp: tuple) -> tuple:
    g = torch.Generator().manual_seed(NOISE_SEED)
    return tuple(v + 0.01 * torch.randn(v.shape, generator=g) for v in mlp)


def _sides(cell, seed, weights="shipped", roughness=None):
    """The program's (scene, env, cam, cfg) and the reference's (scene,
    sky, cam, rc, with the forward megakernel), on the same tensors."""
    from raytracingpbr_tpu_torch.ops.sdf import BunnyMLP
    scene, env, cam, cfg = program.build(cell, seed, "cpu")
    rs, sky, rcam, rc = offline.reference_settings(cell, seed, "cpu")
    if weights == "noised":
        mlp = _noised(rs.bunny)
        scene = scene.replace(bunny=BunnyMLP(*(v.clone() for v in mlp)))
        rs = rs.replace(bunny=tuple(v.clone() for v in mlp))
    if roughness is not None:
        scene = scene.replace(roughness=torch.full_like(scene.roughness,
                                                        roughness))
        rs = rs.replace(roughness=torch.full_like(rs.roughness, roughness))
    for a, b in zip(scene.bunny, rs.bunny):
        assert torch.equal(a, b)
    return (scene, env, cam, cfg), (rs, sky, rcam, rc)


def _program_pass(sides, s):
    """The program's sample pass ``s``: every pixel's colour (read from
    the image) and bounce count, in pixel-id order."""
    scene, env, cam, cfg = sides
    ids = torch.arange(cfg.num_pixels)
    with offline._bounces(ids) as got:
        img = program.port().render_image(scene, env, cam, cfg, spp=1,
                                          sample_offset=s, tonemapped=False)
    assert len(got) == 1
    flat = offline.image_index(ids, cfg.width, cfg.height)
    return img.reshape(-1, 3).index_select(0, flat), got[0]


@pytest.mark.parametrize("weights", ["shipped", "noised"])
def test_pass_equals_the_reference(weights):
    cell = _cell()
    prog, (rs, sky, cam, rc) = _sides(cell, SEED, weights)
    ids = torch.arange(prog[3].num_pixels)
    for s in (2, 2**32 + 5):
        col, bnc = _program_pass(prog, s)
        want_c, want_b = offline.reference_pass(rs, sky, cam, ids, s, rc)
        assert torch.equal(col, want_c), (weights, s)
        assert torch.equal(bnc, want_b), (weights, s)
    assert int(bnc.max()) > 3 and float(col.sum()) > 0


def test_noised_weights_move_the_pass():
    cell = _cell()
    shipped = _program_pass(_sides(cell, 11)[0], 2)
    noised = _program_pass(_sides(cell, 11, "noised")[0], 2)
    assert not torch.equal(shipped[0], noised[0])


def test_forward_stage_kills_below_surface_reflections():
    """On a rough bunny (the glass one is smooth, where a reflection never
    points below the surface) the reference's forward stage zeroes the
    paths whose reflection leaves below the surface, where the base
    (scan-AD's) stage folds the reflection back above and goes on; the
    program's pass follows the forward stage bit for bit."""
    cell = _cell()
    prog, (rs, sky, cam, rc) = _sides(cell, SEED, roughness=0.7)
    ids = torch.arange(prog[3].num_pixels)
    s = 3
    col, bnc = _program_pass(prog, s)
    fwd_c, fwd_b = offline.reference_pass(rs, sky, cam, ids, s, rc)
    assert torch.equal(col, fwd_c) and torch.equal(bnc, fwd_b)
    u = ref.uniform4(ids, s, ref.S_CAMERA, rc["seed"], torch.float32)
    rays = ref.get_ray(cam, ref.pixel_uv(ids, *rc["resolution"], u[0], u[1]),
                       u[2], u[3])
    with torch.no_grad():
        folded = ref.megakernel_trace(rs, sky, rays, ids, s, rc)
    apart = (fwd_c != folded).any(dim=1)
    assert int(apart.sum()) > 0
    # a killed path stops black, where the folded one carries light on
    dark = fwd_c[apart].abs().sum(dim=1) == 0
    assert bool(dark.any())
    assert float(folded[apart][dark].abs().sum()) > 0
    assert stage(rc, "megakernel_trace") is not ref.megakernel_trace


def _port_with(fault):
    real = program.port()

    def render_image(scene, env, cam, cfg, spp=None, sample_offset=0,
                     tonemapped=True):
        if fault == "unchanged":
            sample_offset = 0  # every pass the set-up's first sample
        img = real.render_image(scene, env, cam, cfg, spp=spp,
                                sample_offset=sample_offset,
                                tonemapped=tonemapped)
        return img * 1.001 if fault == "altered" else img

    return types.SimpleNamespace(render_image=render_image)


@pytest.mark.parametrize("fault", [None, "unchanged", "altered"])
def test_offline_fault(fault):
    cell = _cell(size=(24, 14), max_raytrace=8)
    cell.traffic = dict(cell.traffic, warmup_units=1, check_window_from=2)
    # a window long enough for the two drawn passes (about 0.5 s each)
    run = harness.run_cell(cell, 2**31 + 5, 2.0, False, "cpu",
                           time.perf_counter(), _port_with(fault))
    assert run.attempted >= 2 and len(run.extra["checked_samples"]) == 2
    out = harness.result_line(cell, run, False, "cpu", 1)
    assert out["correct"] is (fault is None), out["compared"]
    assert out["metrics"]["msps"]["value"] > 0


@pytest.mark.parametrize("seed", [3, 2**31 + 9, 77])
def test_bfloat16_control_fails(seed):
    cell = _cell()
    got = offline.control(cell, seed, "cpu", "bfloat16")
    assert got["mismatch_pct"] > cell.limits["mismatch_pct"]["limit"], got


def _trace(kind="offline", marches=(0.0, 300.0, 500.0, 700.0, 900.0),
           needed=(1000, 400, 5, 9, 2000)):
    kernels = [("elementwise_kernel", 50.0, 10.0)]
    kernels += [(f"pool_kernel<{j}>", t, 20.0) for j, t in enumerate(marches)]
    bounds = [{"needed": n, "bound_ms": 0.001} for n in needed]
    return tracelib.Trace(kind, 2, (0.0, 1000.0), kernels, kernels, [], [],
                          bounds)


def test_tail_reader():
    read = tracelib.load_reader(harness.reader_path("tail_ms.pass"))
    # the tail: the calls needing under 1% of 2000 (5 and 9): 500 -> 700
    # and 700 -> 900 us, over 2 passes
    assert read(_trace()) == pytest.approx(0.4 / 2)
    # the last call in the tail runs to the sub-window's end
    assert read(_trace(needed=(2000, 400, 5, 9, 1))) == pytest.approx(
        (200 + 200 + 100) / 1e3 / 2)
    assert read(_trace(needed=(1, 2, 3, 4, 5))) == 0.0
    assert read(_trace(needed=(1000, 400, 5, 9))) is None
    assert read(_trace(marches=(0.0, 300.0))) is None
    assert read(_trace(kind="grad")) is None
    for name in ("launches.pass", "march_ms.pass", "device_idle_pct.pass",
                 "march_roofline_pct.pass"):
        r = tracelib.load_reader(harness.reader_path(name))
        assert r(_trace()) is not None and r(_trace(kind="frames")) is None
