"""The benchmark's plain reference against the program on the CPU, at a
tiny size, for each configuration under each traffic: the program's plain
paths there round as the reference does, so the two agree bit for bit."""
import pytest
import torch

from benchmark import harness, program
from benchmark.kinds import frames, grad
from benchmark.reference import render as ref

from helpers import small_cell

CELLS = ("cornell_full.frames", "bunny_glass.frames", "cornell_full.grad",
         "bunny_glass.grad")


def _program(cell, seed):
    return program.build(cell, seed, "cpu")


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith("frames")])
def test_frames_equal_the_programs(name):
    cell = small_cell(name)
    seed = 2**31 + 17
    rt = program.port()
    scene, env, cam, cfg = _program(cell, seed)
    state = rt.make_frame_state(cfg.num_pixels, device="cpu")
    rs, sky, rcam, rc = harness.reference_side(cell, seed, "cpu")
    ids = torch.arange(cfg.num_pixels)
    st = ref.fresh_state(cfg.num_pixels, "cpu")
    for f in range(3):
        px, state = rt.render_frame(scene, env, cam, state, cfg)
        st = ref.render_frame(rs, sky, rcam, st, f, ids, rc)
        got = frames._gather(state, ids)
        for k in ref.STATE_FIELDS:
            assert torch.equal(got[k], st[k]), (f, k)
        assert torch.equal(px, st["pixels"])
    assert float(st["accum"][:, 3].sum()) > 0


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith("grad")])
def test_grad_step_equals_the_programs(name):
    cell = small_cell(name)
    seed = 11
    rt = program.port()
    scene, env, cam, cfg = _program(cell, seed)
    make, leaves = program.grad_leaves(scene, cell.config["grad_leaves"])
    pid = torch.arange(cfg.num_pixels)
    target = grad.target_image(seed, cfg.num_pixels, "cpu")
    img = rt.render_pixels(make(leaves), env, cam, pid, cfg, 1,
                           sample_offset=3, differentiable=True)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    loss_r, grads_r = grad.reference_step(cell, seed, 3, target, "cpu")
    assert float(loss.detach()) == loss_r
    for k, g in zip(leaves, grads):
        torch.testing.assert_close(g, grads_r[k], rtol=1e-6, atol=1e-9)
    assert any(float(g.abs().max()) > 0 for g in grads_r.values())
