"""The tokyo configuration's reference parts against the program on the
CPU: its frames at a small size bit for bit, the capped cylinder's
distance and gradient, the half-up rollback march on rays built to roll
back, and the bfloat16 control coming out not correct."""
import pytest
import torch

from benchmark import calibrate, harness, program
from benchmark.kinds import frames
from benchmark.reference import march as ref_march
from benchmark.reference import part
from benchmark.reference import render as ref
from benchmark.reference import scene as ref_scene

from helpers import small_cell

SIZE = (48, 27)
# the omega that makes a pair of bounds touch exactly: head-on at a unit
# sphere from 1 out, a 1.5 step lands 0.5 inside it, so d + dist == s
TOUCH_OMEGA = 1.5


def test_frames_equal_the_programs():
    cell = small_cell("tokyo.frames", size=SIZE)
    seed = 2**32 + 1_000_003
    rt = program.port()
    scene, env, cam, cfg = program.build(cell, seed, "cpu")
    assert cfg.omega_policy == rt.OmegaPolicy.ROLLBACK_HALF_UP
    state = rt.make_frame_state(cfg.num_pixels, device="cpu")
    rs, sky, rcam, rc = harness.reference_side(cell, seed, "cpu")
    assert rs.bucket_shapes == ("sphere", "box", "cylinder")
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
    # the carried split march: some lanes roll omega back mid-segment
    w = st["march_state"][:, 1]
    assert bool(((w > 0) & (w < rc["omega"])).any())


def _cylinder_points(n: int, scale) -> torch.Tensor:
    """Seeded points inside, outside, on the axis and on the caps' rims
    of a cylinder of radius ``scale[0]`` and half-height ``scale[1]``."""
    g = torch.Generator().manual_seed(20241)
    r, h = float(scale[0]), float(scale[1])
    free = torch.randn((n, 3), generator=g) * torch.tensor([r, h, r]) * 1.5
    ang = torch.rand((n,), generator=g) * 6.283185307179586
    sign = torch.where(torch.rand((n,), generator=g) < 0.5, -1.0, 1.0)
    rim = torch.stack([r * torch.cos(ang), sign * h, r * torch.sin(ang)], -1)
    axis = torch.stack([torch.zeros(n), free[:, 1], torch.zeros(n)], -1)
    exact = torch.tensor([[r, h, 0.0], [0.0, -h, -r], [r, 0.0, 0.0],
                          [0.0, 0.0, 0.0], [0.0, h, 0.0]])
    return torch.cat([free, rim, axis, exact])


def test_cylinder_equals_the_programs():
    from raytracingpbr_tpu_torch.ops.sdf import sd_cylinder
    cell = small_cell("tokyo.frames", size=SIZE)
    rs, _, _, _ = harness.reference_side(cell, 0, "cpu")
    b = rs.bucket_shapes.index("cylinder")
    lo, hi = rs.splits[b], rs.splits[b + 1]
    scale = rs.scale[lo:hi]
    p = _cylinder_points(4096, scale[0])[:, None, :].requires_grad_(True)
    got = part("shapes", "cylinder").sd(rs, lo, hi, p, True)
    want_p = p.detach().clone().requires_grad_(True)
    want = sd_cylinder(want_p, scale)
    assert torch.equal(got, want)
    assert bool((got < 0).any()) and bool((got > 0).any())
    assert bool((got == 0).any())  # on the rims
    (g,) = torch.autograd.grad(got.sum(), p)
    (gw,) = torch.autograd.grad(want.sum(), want_p)
    assert torch.equal(g, gw)


def _one_sphere(rt):
    """A unit sphere at the origin, in the program's and the reference's
    form."""
    obj = dict(shape="sphere", position=[0.0, 0.0, 0.0],
               rotation=[0.0, 0.0, 0.0], scale=[1.0, 1.0, 1.0],
               albedo=[0.5, 0.5, 0.5], emission=[1.0, 1.0, 1.0],
               roughness=1.0, metallic=0.0, transmission=0.0, ior=1.5)
    spec = rt.ObjectSpec(rt.SHAPE.SPHERE, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                         (1.0, 1.0, 1.0), albedo=(0.5, 0.5, 0.5))
    return (rt.make_scene([spec], box_round=0.0, device="cpu"),
            ref_scene.build_scene([obj], 0.0, "cpu"))


def _hold(rt, scene, rs, cfg, rc, origin, direction, init=None):
    """The program's plain march and the reference's on the same rays,
    every field equal; returns the reference's."""
    from raytracingpbr_tpu_torch.ops.march import march_resumable_plain
    got = march_resumable_plain(scene, origin, direction, cfg, init=init)
    want = ref_march.march(rs, origin, direction, rc, cfg.max_raymarch,
                           init=init)
    for k in ("t", "w", "s", "d", "index", "hit", "fin", "done"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    return want


def test_rollback_half_up_equals_the_programs_march():
    rt = program.port()
    cell = small_cell("tokyo.frames", size=SIZE)
    scene, _, _, cfg = program.build(cell, 5, "cpu")
    rs, _, _, rc = harness.reference_side(cell, 5, "cpu")
    assert rc["omega_policy"] == "rollback_half_up"
    # the tokyo scene from the camera's eye, a trip budget at a time, the
    # state carried between the calls as the wavefront carries it
    g = torch.Generator().manual_seed(99)
    n = 2048
    origin = torch.tensor([0.0, -0.2, 4.0]).expand(n, 3).contiguous()
    direction = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g) * torch.tensor([0.6, 0.3, 0.2])
        - torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    cfg8 = cfg.replace(max_raymarch=8)
    init, seen = None, []
    for _ in range(6):
        r = _hold(rt, scene, rs, cfg8, dict(rc, max_raymarch=8), origin,
                  direction, init)
        init = (r.t, r.w, r.s, r.d)
        seen.append(r.w)
    w = torch.cat(seen)
    # omega moved half way to 1 once, twice and three times
    for k in (1.3, 1.15, 1.075):
        assert bool((torch.abs(w - k) < 1e-6).any()), k
    assert bool(r.hit.any()) and bool((~r.hit).any())


def test_exactly_touching_bounds_roll_back():
    rt = program.port()
    scene, rs = _one_sphere(rt)
    cfg = rt.RenderConfig(resolution=(64, 64), omega=TOUCH_OMEGA,
                          omega_policy=rt.OmegaPolicy.ROLLBACK_HALF_UP,
                          hit_criterion=rt.HitCriterion.RELATIVE,
                          march_t0=0.0, max_raymarch=2)
    rc = ref.settings({"resolution": [64, 64], "omega": TOUCH_OMEGA,
                       "omega_policy": "rollback_half_up",
                       "hit_criterion": "relative", "hit_precision": 1e-4,
                       "march_t0": 0.0, "max_dis": 1e3}, 0)
    origin = torch.tensor([[0.0, 0.0, 2.0], [2.0, 0.0, 0.0]])
    direction = torch.tensor([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]])
    r = _hold(rt, scene, rs, cfg, rc, origin, direction)
    # trip 1: |sd| 1, a 1.5 step to 0.5 inside; trip 2: d + dist = 1.5
    # equals s exactly, so the lane rolls back by s (1 - w) = -0.75
    assert r.t.tolist() == [0.75, 0.75]
    assert r.w.tolist() == [1.25, 1.25]
    assert r.s.tolist() == [-0.75, -0.75]
    assert not bool(r.hit.any())
    # the rest of the march from there: the lanes reach the sphere
    r2 = _hold(rt, scene, rs, cfg.replace(max_raymarch=64),
               dict(rc, max_raymarch=64), origin, direction,
               init=(r.t, r.w, r.s, r.d))
    assert bool(r2.hit.all())


@pytest.mark.parametrize("seed", [3, 2**31 + 9, 77])
def test_bfloat16_control_fails(seed):
    cell = small_cell("tokyo.frames", size=SIZE)
    assert calibrate.control_mode(cell) == "bfloat16"
    got = frames.control(cell, seed, "cpu", "bfloat16", window_frames=4)
    assert any(v > cell.limits[k]["limit"] for k, v in got.items()), got
