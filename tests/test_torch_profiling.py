"""The program's spans (``utils/profiling``: ``span``, ``traced``,
``recording``) on the CPU: the tree a wavefront frame and a differentiable
megakernel trace record, the shared no-op while recording is off, and the
render's bits unchanged by recording.
"""
import threading
from collections import Counter

import pytest
import torch

from raytracingpbr_tpu_torch.core import rng as rnglib
from raytracingpbr_tpu_torch.core.types import Rays, make_frame_state
from raytracingpbr_tpu_torch.models import cornell
from raytracingpbr_tpu_torch.ops import camera as cameralib
from raytracingpbr_tpu_torch.ops import integrator as integ
from raytracingpbr_tpu_torch.ops import replay as replaylib
from raytracingpbr_tpu_torch.ops.ibl import black_sky
from raytracingpbr_tpu_torch.utils import profiling

from .torch_helpers import CPU


def _frame_setup(steps=4):
    cfg = cornell.full_config().replace(
        resolution=(12, 12), max_raymarch=64, march_split=32,
        samples_per_frame=steps)
    return (cornell.full_scene(CPU), black_sky(CPU),
            cornell.full_camera(CPU), cfg)


def _children(rows, i):
    return [r for r in rows if r.parent == i]


def _inside(rows):
    """Every row closed, start <= end, and inside its parent's interval."""
    assert all(r is not None for r in rows)
    for r in rows:
        assert r.start <= r.end
        if r.parent >= 0:
            p = rows[r.parent]
            assert p.start <= r.start and r.end <= p.end, (p, r)


def test_wavefront_frame_records_its_layer_tree():
    """One Cornell frame: ``frame`` over ``samples_per_frame`` ``step``s
    and a ``post``; each step over one ``march``, ``shade``, ``sky`` and
    ``camera`` and three ``rng`` draws (roulette, camera, shading)."""
    scene, env, cam, cfg = _frame_setup()
    state = make_frame_state(cfg.num_pixels, device=CPU)
    _, state = integ.render_frame(scene, env, cam, state, cfg)
    with profiling.recording() as rows:
        integ.render_frame(scene, env, cam, state, cfg)
    _inside(rows)
    assert {r.tid for r in rows} == {threading.get_ident()}
    top = [i for i, r in enumerate(rows) if r.parent == -1]
    assert [rows[i].name for i in top] == ["frame"]
    kids = _children(rows, top[0])
    assert [r.name for r in kids] == ["step"] * cfg.samples_per_frame + [
        "post"]
    for i, r in enumerate(rows):
        if r.name != "step":
            continue
        assert Counter(c.name for c in _children(rows, i)) == Counter(
            march=1, shade=1, sky=1, camera=1, rng=3)
    assert Counter(r.name for r in rows) == Counter(
        frame=1, post=1, step=4, march=4, shade=4, sky=4, camera=4, rng=12)


def _megakernel_rays(n, toward_the_box=True):
    """Rays from the Cornell camera's eye: into the box, or straight back
    out of it through the open front (every lane misses at once)."""
    o = torch.tensor([[0.0, 0.0, 3.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, -1.0 if toward_the_box else 1.0]])
    d = (d + 0.05 * torch.randn(n, 3, generator=torch.Generator()
                                .manual_seed(0)))
    d = d / d.norm(dim=-1, keepdim=True)
    return Rays(origin=o, direction=d, color=torch.ones(n, 3),
                depth=torch.zeros(n, dtype=torch.int32))


@pytest.mark.parametrize("toward_the_box", [True, False])
def test_megakernel_records_a_bounce_and_a_sync_a_bounce(toward_the_box):
    """A differentiable ``megakernel_trace``: one ``bounce`` for each run
    of the loop, each over one ``sync`` (the exit check) beside its
    ``march``, ``shade``, ``sky`` and ``rng``. Into the box the paths last
    the bounce cap; out of it every lane dies at the first bounce, so the
    loop runs, and checks, once."""
    scene = cornell.full_scene(CPU)
    albedo = scene.albedo.clone().requires_grad_(True)
    scene = scene.replace(albedo=albedo)
    cfg = cornell.full_config().replace(
        resolution=(8, 8), max_raymarch=64, max_raytrace=3,
        light_quality=1e9)
    rays = _megakernel_rays(64, toward_the_box)
    pid = torch.arange(64)
    with profiling.recording() as rows:
        out = integ.megakernel_trace(scene, black_sky(CPU), rays, pid, 0,
                                     cfg, differentiable=True)
    _inside(rows)
    bounces = [i for i, r in enumerate(rows) if r.name == "bounce"]
    assert all(rows[i].parent == -1 for i in bounces)
    want = cfg.max_raytrace if toward_the_box else 1
    assert len(bounces) == want
    assert int(out.bounces.max()) == (want if toward_the_box else 0)
    for i in bounces:
        got = Counter(c.name for c in _children(rows, i))
        assert got["sync"] == 1 and got["march"] == 1 and got["sky"] == 1
        assert got["shade"] == 1 and got["rng"] == 2
    assert sum(r.name == "sync" for r in rows) == want
    out.color.sum().backward()
    assert albedo.grad is not None


@pytest.mark.parametrize("toward_the_box,syncs", [(True, 3), (False, 2)])
def test_replay_records_its_exit_checks(toward_the_box, syncs):
    """Path replay's forward loop asks the card whether any lane is alive
    before each bounce under the cap: a ``sync`` each time. Into the box
    the paths last the 3 bounces (3 checks); out of it every lane dies at
    the first, and the second check ends the loop."""
    scene = cornell.full_scene(CPU)
    cfg = cornell.full_config().replace(
        resolution=(8, 8), max_raymarch=64, max_raytrace=3,
        light_quality=1e9)
    rays = _megakernel_rays(64, toward_the_box)
    with profiling.recording() as rows:
        replaylib.trace_replay(scene, black_sky(CPU), rays, torch.arange(64),
                               0, cfg)
    _inside(rows)
    names = Counter(r.name for r in rows)
    assert names["sync"] == syncs and names["bounce"] == 0


def test_off_is_one_shared_object_and_records_nothing():
    """Off, ``span`` returns the same object whatever the name, and no
    render leaves a row; ``traced`` keeps the function's name and
    signature; recording does not nest; a span on another thread has no
    parent on this one's stack."""
    assert profiling.span("frame") is profiling.span("march")
    with profiling.span("frame"):
        assert profiling.span("x") is profiling.span("y")
    scene, env, cam, cfg = _frame_setup(steps=1)
    state = make_frame_state(cfg.num_pixels, device=CPU)
    integ.render_frame(scene, env, cam, state, cfg)
    with profiling.recording() as rows:
        pass
    assert rows == []
    assert rnglib.uniform4.__name__ == "uniform4"
    assert cameralib.get_ray.__wrapped__.__name__ == "get_ray"
    with profiling.recording() as rows:
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass
        with profiling.span("outer"):
            th = threading.Thread(target=_one_span, args=("inner",))
            th.start()
            th.join()
    assert profiling._rows is None
    assert [(r.name, r.parent) for r in rows] == [("outer", -1),
                                                  ("inner", -1)]
    assert rows[0].tid == threading.get_ident() != rows[1].tid


def _one_span(name):
    with profiling.span(name):
        pass


def test_render_is_bit_equal_with_recording_on():
    scene, env, cam, cfg = _frame_setup()
    a = b = make_frame_state(cfg.num_pixels, device=CPU)
    for _ in range(2):
        pa, a = integ.render_frame(scene, env, cam, a, cfg)
    with profiling.recording() as rows:
        for _ in range(2):
            pb, b = integ.render_frame(scene, env, cam, b, cfg)
    assert rows
    assert torch.equal(pa, pb)
    for k in ("accum", "pixels", "respawn", "hit_t", "march_state",
              "march_cum"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in ("origin", "direction", "color", "depth"):
        assert torch.equal(getattr(a.rays, k), getattr(b.rays, k)), k
