"""The harness's judgement with the timed path broken underneath: a run
on the CPU at a tiny size that skips only the look for a card, with the
program's entry replaced by one that returns its state unchanged, leaves
half of the pixels out, or alters an answer where it is produced, comes
out not correct; the same run unbroken comes out correct."""
import time
import types

import pytest
import torch

from benchmark import harness, program

from helpers import small_cell


def _frames_rt(fault):
    real = program.port()

    def render_frame(scene, env, cam, state, cfg):
        px, new = real.render_frame(scene, env, cam, state, cfg)
        if fault == "unchanged":
            return state.pixels, state
        if fault == "half":
            # the second half of the pixels left out: their state as it was
            h = cfg.num_pixels // 2
            cut = lambda a, b: torch.cat([a[:h], b[h:]])
            rays = type(new.rays)(*(cut(getattr(new.rays, f), getattr(
                state.rays, f)) for f in ("origin", "direction", "color",
                                          "depth")))
            new = new.replace(
                rays=rays, accum=cut(new.accum, state.accum),
                pixels=cut(new.pixels, state.pixels),
                respawn=cut(new.respawn, state.respawn),
                hit_t=cut(new.hit_t, state.hit_t),
                march_state=cut(new.march_state, state.march_state),
                march_cum=cut(new.march_cum, state.march_cum))
            return new.pixels, new
        if fault == "altered":
            new = new.replace(accum=new.accum * 1.001)
            return px, new
        return px, new

    return types.SimpleNamespace(make_frame_state=real.make_frame_state,
                                 render_frame=render_frame)


def _grad_rt(fault):
    real = program.port()

    def render_pixels(scene, env, cam, pixel_id, cfg, spp, sample_offset=0,
                      differentiable=True):
        if fault == "unchanged":
            sample_offset = 0  # every step the set-up's first
        if fault == "half":
            # every other pixel rendered, each standing for two
            img = real.render_pixels(scene, env, cam, pixel_id[::2], cfg,
                                     spp, sample_offset, differentiable)
            return img.repeat_interleave(2, dim=0)[:pixel_id.shape[0]]
        img = real.render_pixels(scene, env, cam, pixel_id, cfg, spp,
                                 sample_offset, differentiable)
        return img * 1.001 if fault == "altered" else img

    return types.SimpleNamespace(render_pixels=render_pixels)


def _correct(cell, rt, seed=2**31 + 5):
    run = harness.run_cell(cell, seed, 0.3, False, "cpu",
                           time.perf_counter(), rt)
    return harness.result_line(cell, run, False, "cpu", 1)["correct"]


@pytest.mark.parametrize("name", ["cornell_full.frames",
                                  "bunny_glass.frames"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_frames_fault(name, fault):
    assert _correct(small_cell(name), _frames_rt(fault)) is (fault is None)


@pytest.mark.parametrize("name", ["cornell_full.grad", "bunny_glass.grad"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_grad_fault(name, fault):
    assert _correct(small_cell(name), _grad_rt(fault)) is (fault is None)
