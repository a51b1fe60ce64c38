"""The surface normal on the CPU: ``calc_normal_closed_plain`` (the
normal kernel's arithmetic, ``csrc/normal.cu``, written in PyTorch) bit
for bit against autograd's first-order ``calc_normal``, on the analytic
shapes and on the bunny's sin-MLP, and ``calc_normal``'s dispatch: the
CPU, float64 and the second-order branch keep autograd. The kernel itself
runs on the card (``tests/test_torch_kernel.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch.kernels import normal_kernel
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops.sdf import SHAPE

from .torch_helpers import (CPU, NORMAL_POSES, assert_normals_bit_equal,
                            bunny_beside_shapes, bunny_normal_points,
                            many_objects_scene, mixed_analytic_scene,
                            normal_points, normal_scene)

SCENES = {"cornell": cornell.full_scene, "tokyo": demo.scene_demo_scene,
          "engine": demo.engine_scene, "mixed": mixed_analytic_scene,
          "many_objects": many_objects_scene}


@pytest.mark.parametrize("box_round", [0.03, 0.0], ids=["round", "sharp"])
@pytest.mark.parametrize("pose", sorted(NORMAL_POSES))
def test_closed_plain_bit_equal_to_autograd(pose, box_round):
    """Every analytic shape in every pose (identity, signed permutations,
    Cornell's -253 degree turn, a general rotation, an animated scene with
    a non-zero ``local_offset``), rounded and sharp boxes: faces, edges and
    corners (``amax`` ties), the cylinder's rim and axis, the sphere's
    centre (``safe_norm`` at 0), inside and outside, missed lanes at far
    points and NaN points, each lane bit for bit, zeros' signs too."""
    scene = normal_scene(pose, box_round, CPU)
    idx, p = normal_points(scene, 4096, seed=len(pose))
    want = tscene.calc_normal_autograd(scene, idx, p)
    assert_normals_bit_equal(tscene.calc_normal_closed_plain(scene, idx, p),
                             want)
    # the NaN lanes, and under signed permutations the exact zeros, are
    # there to be matched
    assert bool(torch.isnan(want).any())
    if pose in ("identity", "permutation", "turned"):
        assert bool((want == 0).any())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closed_plain_bit_equal_on_model_scenes(name):
    """The model scenes (Cornell's eight boxes, the tokyo and engine
    seven, the mixed and 128-object test scenes) at points about their
    objects, int64 indices, a batch shape of two axes."""
    scene = SCENES[name](CPU)
    idx, p = normal_points(scene, 4096, seed=7)
    n = idx.shape[0] // 2 * 2
    idx = idx[:n].to(torch.int64).reshape(2, -1)
    p = p[:n].reshape(2, -1, 3)
    got = tscene.calc_normal_closed_plain(scene, idx, p)
    assert got.shape == p.shape
    assert_normals_bit_equal(got, tscene.calc_normal_autograd(scene, idx, p))


BUNNY_SCENES = {
    "glass": bunny.glass_scene, "metal": bunny.metal_scene,
    "beside_shapes": bunny_beside_shapes,
    "animated": lambda d: tscene.animate(bunny.glass_scene(d), 37),
    "beside_shapes_animated": lambda d: tscene.animate(
        bunny_beside_shapes(d), 70)}


@pytest.mark.parametrize("name", sorted(BUNNY_SCENES))
def test_closed_plain_bit_equal_on_bunny_scenes(name):
    """The bunny's sin-MLP gradient (``_grad_bunny``) and the analytic
    shapes beside it, animated (``local_offset`` a broadcast view) or not:
    the MLP's lanes inside the unit sphere, its centre and the sphere
    itself (r = 1 stays on the MLP), ``safe_norm``'s lanes outside, far
    missed lanes, NaN and infinite points (NaN wherever a curved object,
    the bunny among them, adds NaN), int32 and int64 indices, bit for bit.
    This CPU's matrix product sums each contraction in k's order with one
    fused multiply-add a term, as the kernel does, so both sides'
    products agree to the bit."""
    scene = BUNNY_SCENES[name](CPU)
    idx, p = bunny_normal_points(scene, 4096, seed=5)
    for ids in (idx, idx.to(torch.int64)):
        want = tscene.calc_normal_autograd(scene, ids, p)
        assert_normals_bit_equal(
            tscene.calc_normal_closed_plain(scene, ids, p), want)
    bunny_lanes = idx == scene.shape_types.index(SHAPE.BUNNY)
    r = torch.linalg.vector_norm(p - scene.position[-1], dim=-1)
    assert bool((bunny_lanes & (r < 1)).any())
    assert bool((bunny_lanes & (r > 1) & torch.isfinite(r)).any())
    assert bool(torch.isnan(want[bunny_lanes]).any())
    assert not bool(torch.isnan(want[bunny_lanes & (r < 1)]).any())


def test_num_curved_counts_the_bunny():
    """The bunny's gradient reads the point, and at a point not finite
    it is NaN, so it counts among the curved objects."""
    assert normal_kernel.num_curved(bunny.glass_scene(CPU)) == 1
    assert normal_kernel.num_curved(bunny_beside_shapes(CPU)) == 5


def _p_requires_grad(scene, idx, p):
    return scene, p.clone().requires_grad_(True)


def _scale_requires_grad(scene, idx, p):
    return scene.replace(scale=scene.scale.clone().requires_grad_(True)), p


ROUTES = {
    # case: (make the inputs, grad mode, route)
    "cpu_float32": (lambda s, i, p: (s, p), True, "autograd_first_order"),
    "cpu_float64": (lambda s, i, p: (s.to(torch.float64), p.double()), True,
                    "autograd_first_order"),
    "p_requires_grad": (_p_requires_grad, True, "autograd_second_order"),
    "scale_requires_grad": (_scale_requires_grad, True,
                            "autograd_second_order"),
    "grad_off_p_requires_grad": (_p_requires_grad, False, "autograd_first_order"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_calc_normal_routes_keep_autograd_off_the_card(case):
    """On the CPU, in float64 and on the second-order branch
    ``calc_normal`` is autograd's normal as before, and
    ``NORMAL_ROUTES`` counts the call under that route alone."""
    make, grad, route = ROUTES[case]
    base = normal_scene("general", 0.03, CPU)
    idx, p = normal_points(base, 256, seed=3)
    scene, q = make(base, idx, p)
    before = dict(tscene.NORMAL_ROUTES)
    with torch.set_grad_enabled(grad):
        got = tscene.calc_normal(scene, idx, q)
    assert tscene.NORMAL_ROUTES == before | {route: before[route] + 1}
    second = route == "autograd_second_order"
    assert got.requires_grad == second
    want = tscene.calc_normal_autograd(scene, idx, q, create_graph=second)
    assert_normals_bit_equal(got.detach(), want.detach())


def test_calc_normal_bunny_scene_keeps_autograd():
    """On the CPU a scene with the bunny takes autograd's first-order
    normal, the analytic objects beside it too."""
    scene = bunny_beside_shapes(CPU)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, scene.num_objects, 512),
                          dtype=torch.int32)
    p = torch.as_tensor(rng.normal(0, 0.7, (512, 3)).astype(np.float32))
    before = dict(tscene.NORMAL_ROUTES)
    got = tscene.calc_normal(scene, idx, p)
    assert tscene.NORMAL_ROUTES == before | {
        "autograd_first_order": before["autograd_first_order"] + 1}
    assert_normals_bit_equal(got, tscene.calc_normal_autograd(scene, idx, p))


def test_normal_kernel_refuses_cpu_points():
    """The wrapper raises on a CPU ``p``: ``calc_normal`` never sends one
    there."""
    scene = normal_scene("identity", 0.03, CPU)
    idx, p = normal_points(scene, 8)
    with pytest.raises(ValueError, match="CUDA"):
        normal_kernel.calc_normal(scene, idx, p)


def _cu_shapes():
    src = (Path(normal_kernel.__file__).resolve().parent.parent / "csrc"
           / "normal.cu").read_text()
    enum = re.search(r"enum Shape \{([^}]*)\}", src)[1]
    return {m[1]: int(m[2]) for m in re.finditer(r"(\w+) = (\d+)", enum)}


@pytest.mark.parametrize("shape", list(SHAPE), ids=lambda s: s.name)
def test_kernel_shape_ids_are_the_scenes(shape):
    """``csrc/normal.cu``'s shape ids, read from the source, equal
    ``ops/sdf.SHAPE``'s, and :func:`normal_kernel.num_curved` counts the
    shapes whose gradient reads the point."""
    assert _cu_shapes()[shape.name] == int(shape)
    scene = normal_scene("identity", 0.03, CPU)
    assert normal_kernel.num_curved(scene) == sum(
        t in (SHAPE.SPHERE, SHAPE.BOX, SHAPE.CYLINDER, SHAPE.CONE)
        for t in scene.shape_types) == 5
