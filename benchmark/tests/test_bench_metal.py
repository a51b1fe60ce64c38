"""The metal bunny configuration's reference parts against the program on
the CPU: its frames at a small size bit for bit (both sides evaluate the
bunny's MLP in its matrix form there, the plain version of the program's
tensor-core march), on the shipped weights and on seeded noisy ones; the
``bunny_mxu`` feature that the reference's settings ask for; the black
background; and the bfloat16 control coming out not correct. The TF32
control needs the card (``benchmark/calibrate.py``)."""
import pytest
import torch

from benchmark import calibrate, harness, program
from benchmark.kinds import frames
from benchmark.reference import march as ref_march
from benchmark.reference import render as ref
from benchmark.reference import stage

from helpers import small_cell

SIZE = (48, 27)
NOISE_SEED = 20260
# the corner pixel (column 0, row 0) and the centre one of SIZE: the
# camera's ray at the corner misses the bunny, the centre's hits it
CORNER, CENTRE = 0, (SIZE[0] // 2) * SIZE[1] + SIZE[1] // 2


def _noised(mlp: tuple) -> tuple:
    """The weights plus seeded N(0, 0.01) noise, so that a transposed or
    misordered tensor on one side shows."""
    g = torch.Generator().manual_seed(NOISE_SEED)
    return tuple(v + 0.01 * torch.randn(v.shape, generator=g) for v in mlp)


def _sides(cell, seed, weights: str):
    """The program's (scene, env, cam, cfg) and the reference's
    (scene, sky, cam, rc) of ``cell``, on the same MLP tensors."""
    from raytracingpbr_tpu_torch.ops.sdf import BunnyMLP
    scene, env, cam, cfg = program.build(cell, seed, "cpu")
    rs, sky, rcam, rc = harness.reference_side(cell, seed, "cpu")
    if weights == "noised":
        mlp = _noised(rs.bunny)
        scene = scene.replace(bunny=BunnyMLP(*(v.clone() for v in mlp)))
        rs = rs.replace(bunny=tuple(v.clone() for v in mlp))
    for a, b in zip(scene.bunny, rs.bunny):
        assert torch.equal(a, b)
    return (scene, env, cam, cfg), (rs, sky, rcam, rc)


def _frames(cell, seed, weights: str, n: int = 3):
    """``n`` frames of every pixel on both sides, each frame's state and
    displayed pixels held equal bit for bit; returns the last states."""
    rt = program.port()
    (scene, env, cam, cfg), (rs, sky, rcam, rc) = _sides(cell, seed,
                                                          weights)
    state = rt.make_frame_state(cfg.num_pixels, device="cpu")
    ids = torch.arange(cfg.num_pixels)
    st = ref.fresh_state(cfg.num_pixels, "cpu")
    for f in range(n):
        px, state = rt.render_frame(scene, env, cam, state, cfg)
        st = ref.render_frame(rs, sky, rcam, st, f, ids, rc)
        got = frames._gather(state, ids)
        for k in ref.STATE_FIELDS:
            assert torch.equal(got[k], st[k]), (weights, f, k)
        assert torch.equal(px, st["pixels"]), (weights, f)
    return got, st


@pytest.mark.parametrize("weights", ["shipped", "noised"])
def test_frames_equal_the_programs(weights):
    cell = small_cell("bunny_metal.frames", size=SIZE)
    rc = cell.render()
    assert rc["bunny_mxu"] and rc["black_background"]
    got, st = _frames(cell, 2**32 + 2_000_003, weights)
    assert float(st["accum"][:, :3].sum()) > 0
    # the centre's camera ray hits the bunny; rays are still in flight
    # across the split march
    assert float(st["hit_t"][CENTRE]) < ref.NO_HIT_T
    assert bool((st["march_cum"] > 0).any())


def test_noised_weights_move_the_frame():
    cell = small_cell("bunny_metal.frames", size=SIZE)
    _, shipped = _frames(cell, 11, "shipped", n=1)
    _, noised = _frames(cell, 11, "noised", n=1)
    assert not torch.equal(shipped["accum"], noised["accum"])


def test_settings_need_the_feature():
    cell = small_cell("bunny_metal.frames", size=SIZE)
    render = cell.render()
    with pytest.raises(ValueError, match="bunny_mxu"):
        ref.settings(render, 0, ())
    rc = ref.settings(render, 0, ("bunny_mxu",))
    assert rc["features"] == ("bunny_mxu",)
    assert cell.config["reference_features"] == ["bunny_mxu"]


def test_black_background_kills_primary_misses():
    cell = small_cell("bunny_metal.frames", size=SIZE)
    got, st = _frames(cell, 5, "shipped", n=1)
    # the corner's camera ray misses: its samples count, and are black
    for side in (got, st):
        assert float(side["accum"][CORNER, 3]) > 0
        assert float(side["accum"][CORNER, :3].abs().sum()) == 0.0
        assert float(side["pixels"][CORNER].abs().sum()) == 0.0
    # with the sky behind it the same pixel is lit, on both sides
    cell.config["render"]["black_background"] = False
    got, st = _frames(cell, 5, "shipped", n=1)
    for side in (got, st):
        assert float(side["pixels"][CORNER].sum()) > 0


def test_reference_march_takes_the_matrix_form():
    cell = small_cell("bunny_metal.frames", size=SIZE)
    rs, _, _, rc = harness.reference_side(cell, 0, "cpu")
    g = torch.Generator().manual_seed(3)
    n = 512
    origin = torch.tensor([0.0, 0.0, 3.0]).expand(n, 3).contiguous()
    direction = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g) * 0.2
        - torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    feat = stage(rc, "march")(rs, origin, direction, rc, 64, chains=True)
    mat = ref_march.march(rs, origin, direction, rc, 64, chains=False)
    for k in feat._fields:
        assert torch.equal(getattr(feat, k), getattr(mat, k)), k
    assert bool(mat.hit.any())
    # the two forms round apart on these rays, so the test tells them apart
    chained = ref_march.march(rs, origin, direction, rc, 64, chains=True)
    assert not torch.equal(chained.t, mat.t)


@pytest.mark.parametrize("seed", [3, 2**31 + 9, 77])
def test_bfloat16_control_fails(seed):
    cell = small_cell("bunny_metal.frames", size=SIZE)
    assert calibrate.control_mode(cell) == "tf32"
    got = frames.control(cell, seed, "cpu", "bfloat16", window_frames=4)
    assert any(v > cell.limits[k]["limit"] for k, v in got.items()), got
