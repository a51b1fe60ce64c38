"""``ops/scene.materials_at``'s own backward on the CPU.

Where a part of the material table requires grad, ``materials_at`` is an
autograd Function: the gather's values as before, a gradient only for the
parts that require one, and the fields of the others non-differentiable.
On the CPU its backward is ``kernels/material_grad_kernel``'s plain
version, which must give the bits of ``index_select``'s backward (the
gather as it stood before, written out here as the reference). The CUDA
kernel itself runs on the card (``tests/test_torch_kernel.py``)."""
import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch.kernels import material_grad_kernel as mgk
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.ops import scene as tscene
from raytracingpbr_tpu_torch.ops.sdf import BunnyMLP
from raytracingpbr_tpu_torch.parallel import train as ptrain

from .torch_helpers import CPU

PARTS = ("albedo", "emission", "roughness", "metallic", "transmission", "ior")
SCENES = {1: bunny.glass_scene, 7: demo.scene_demo_scene,
          8: cornell.full_scene}
LEAVES = {"albedo": ("albedo",), "albedo_roughness": ("albedo", "roughness"),
          "all": PARTS}


def gather_before(parts, idx):
    """``materials_at`` as it stood before its own backward: the six
    fields sliced from ``index_select`` of the (n_obj, 10) table, with
    PyTorch's autograd (``index_add_`` into the whole table)."""
    albedo, emission, roughness, metallic, transmission, ior = parts
    table = torch.cat([albedo, emission, roughness[:, None],
                       metallic[:, None], transmission[:, None],
                       ior[:, None]], -1)
    m = table.index_select(0, idx.reshape(-1).to(torch.int64)).reshape(
        idx.shape + (10,))
    return (m[..., 0:3], m[..., 3:6], m[..., 6], m[..., 7], m[..., 8],
            m[..., 9])


def random_materials(scene, leaves, seed, dtype=torch.float32):
    """The scene with each part drawn at random, the named ones leaves
    that require grad."""
    rng = np.random.default_rng(seed)
    parts = {k: torch.as_tensor(rng.uniform(0.1, 2.0, getattr(scene, k)
                                            .shape), dtype=dtype)
             for k in PARTS}
    for k in leaves:
        parts[k].requires_grad_(True)
    return scene.replace(**parts)


def lanes(n_obj, n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "one_object":
        return torch.full((n,), n_obj - 1, dtype=torch.int32)
    if kind == "empty":
        return torch.zeros((0,), dtype=torch.int32)
    idx = torch.as_tensor(rng.integers(0, n_obj, n), dtype=torch.int32)
    if kind == "int64_batch":
        return idx[: n // 2 * 2].to(torch.int64).reshape(2, -1)
    return idx


@pytest.mark.parametrize("kind", ["spread", "one_object", "empty",
                                  "int64_batch"])
@pytest.mark.parametrize("leaves", sorted(LEAVES))
@pytest.mark.parametrize("n_obj", sorted(SCENES))
def test_gradients_bit_equal_to_index_select(n_obj, leaves, kind):
    """Forward values and every leaf's gradient, under random field
    gradients, bit for bit against the gather before (1, 7 and 8 objects;
    the albedo alone, with the roughness, all six; lanes spread over the
    objects, all on one, none, int64 indices of a batch shape)."""
    base = SCENES[n_obj](CPU)
    assert base.num_objects == n_obj
    scene = random_materials(base, LEAVES[leaves], seed=n_obj)
    idx = lanes(n_obj, 3001, seed=len(kind), kind=kind)
    parts = [getattr(scene, k) for k in PARTS]
    want = gather_before(parts, idx)
    got = tscene.materials_at(scene, idx)
    gen = torch.Generator().manual_seed(n_obj)
    gs = [torch.randn(w.shape, generator=gen, dtype=w.dtype) for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w.detach())
        assert g.shape == w.shape
    sel = [getattr(scene, k) for k in LEAVES[leaves]]
    pairs = [(f, g) for f, g in zip(got, gs) if f.requires_grad]
    new = torch.autograd.grad([f for f, _ in pairs], sel,
                              [g for _, g in pairs])
    old = torch.autograd.grad(list(want), sel, gs)
    for a, b in zip(new, old):
        assert a.shape == b.shape and torch.equal(a, b)


def test_a_leaf_whose_field_gets_no_gradient_gets_zeros():
    """The albedo and the roughness leaves, only the roughness field used:
    the albedo's gradient is zeros, as the gather before gave."""
    scene = random_materials(cornell.full_scene(CPU), ("albedo", "roughness"),
                             seed=3)
    idx = lanes(8, 500, seed=1, kind="spread")
    got = tscene.materials_at(scene, idx)
    want = gather_before([getattr(scene, k) for k in PARTS], idx)
    leaves = [scene.albedo, scene.roughness]
    new = torch.autograd.grad(got.roughness.square().sum(), leaves)
    old = torch.autograd.grad(want[2].square().sum(), leaves)
    assert torch.equal(new[0], torch.zeros_like(new[0]))
    for a, b in zip(new, old):
        assert torch.equal(a, b)


@pytest.mark.parametrize("leaves", sorted(LEAVES))
def test_fields_without_a_leaf_are_not_differentiable(leaves):
    """A field requires grad exactly where its part does: the albedo leaf
    alone leaves the roughness, metallic and ior fields (and so the
    sampled direction) out of the graph. The route is the Function."""
    scene = random_materials(cornell.full_scene(CPU), LEAVES[leaves], seed=0)
    idx = lanes(8, 64, seed=0, kind="spread")
    before = dict(tscene.MATERIAL_ROUTES)
    got = tscene.materials_at(scene, idx)
    assert tscene.MATERIAL_ROUTES == before | {
        "function": before["function"] + 1}
    assert [f.requires_grad for f in got] == [k in LEAVES[leaves]
                                              for k in PARTS]


@pytest.mark.parametrize("case", ["no_leaf", "grad_off"])
def test_without_a_leaf_the_plain_gather_runs(case):
    """No part requires grad, or grad mode is off: the plain gather (the
    frames' path), the same values, nothing requires grad."""
    leaves = () if case == "no_leaf" else ("albedo",)
    scene = random_materials(cornell.full_scene(CPU), leaves, seed=2)
    idx = lanes(8, 64, seed=2, kind="spread")
    before = dict(tscene.MATERIAL_ROUTES)
    with torch.set_grad_enabled(case != "grad_off"):
        got = tscene.materials_at(scene, idx)
    assert tscene.MATERIAL_ROUTES == before | {
        "plain_gather": before["plain_gather"] + 1}
    want = gather_before([getattr(scene, k) for k in PARTS], idx)
    for g, w in zip(got, want):
        assert not g.requires_grad
        assert torch.equal(g, w.detach())


@pytest.mark.parametrize("leaves", ["albedo_roughness", "all"])
def test_gradcheck_float64(leaves):
    """``torch.autograd.gradcheck`` of the gather in float64 over the
    parts that require grad, three objects, lanes on each and one on
    none."""
    scene = random_materials(cornell.full_scene(CPU), (), seed=4,
                             dtype=torch.float64)
    idx = torch.tensor([0, 2, 2, 5, 0, 7, 2, 5, 5, 0], dtype=torch.int32)
    names = LEAVES[leaves]
    start = [getattr(scene, k).clone().requires_grad_(True) for k in names]

    def fn(*xs):
        got = tscene.materials_at(scene.replace(**dict(zip(names, xs))), idx)
        return tuple(f for f in got if f.requires_grad)

    assert torch.autograd.gradcheck(fn, start)


def test_double_backward_raises():
    """The backward is marked once-differentiable: differentiating the
    gradient again raises, naming it."""
    scene = random_materials(cornell.full_scene(CPU), ("albedo",), seed=5)
    idx = lanes(8, 32, seed=5, kind="spread")
    got = tscene.materials_at(scene, idx)
    (g,) = torch.autograd.grad(got.albedo.square().sum(), scene.albedo,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_cuda_path_refuses_cpu_tensors():
    """The kernel's wrapper raises on a CPU index: ``material_grad`` never
    sends one there."""
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mgk.material_grad_cuda(idx, [torch.ones(4, 3)] + [None] * 5,
                               [True] + [False] * 5, 8)


@pytest.mark.parametrize("n", [0, 1, 31, 257, 230_400, 262_145, 2_073_600,
                               10**8 + 7])
def test_layout_covers_every_lane(n):
    """The partial sums' chunks: at most ``MAX_BLOCKS`` blocks of a
    multiple of 32 lanes, covering ``n`` lanes, none empty."""
    blocks, chunk = mgk.layout(n)
    if n == 0:
        assert (blocks, chunk) == (0, 0)
        return
    assert 1 <= blocks <= mgk.MAX_BLOCKS and chunk % 32 == 0
    assert (blocks - 1) * chunk < n <= blocks * chunk


def _grad_step_routes(scene, env, cam, cfg, names):
    """One scan-AD step (``render_pixels`` at one sample, then
    ``torch.autograd.grad`` of the mean squared image) with ``names``
    leaves: ``(NORMAL_ROUTES, MATERIAL_ROUTES)`` counted over it."""
    src = {"bunny_" + k: v for k, v in zip(BunnyMLP._fields,
                                           scene.bunny or ())}
    leaves = {n: (src[n] if n.startswith("bunny_") else getattr(scene, n))
              .detach().clone().requires_grad_(True) for n in names}
    kw = {k: v for k, v in leaves.items() if not k.startswith("bunny_")}
    if src:
        kw["bunny"] = BunnyMLP(*(leaves.get("bunny_" + k, src["bunny_" + k])
                                 for k in BunnyMLP._fields))
    normal, material = (dict(tscene.NORMAL_ROUTES),
                        dict(tscene.MATERIAL_ROUTES))
    pid = torch.arange(cfg.num_pixels, dtype=torch.int64)
    img = ptrain.render_pixels(scene.replace(**kw), env, cam, pid, cfg, 1,
                               sample_offset=3)
    grads = torch.autograd.grad(img.square().mean(), list(leaves.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[-1].abs().sum()) > 0
    return ({k: v - normal[k] for k, v in tscene.NORMAL_ROUTES.items()},
            {k: v - material[k] for k, v in tscene.MATERIAL_ROUTES.items()})


def test_grad_step_routes():
    """A Cornell step at 16x16 with the albedo leaf (the
    ``cornell_full.grad`` cell's leaves) and a glass-bunny step at 8x8
    with the MLP, the matrix and the albedo (``bunny_glass.grad``'s), 8
    bounces each: two Function calls a bounce (the shading's and the
    emission's). The Cornell step's normals are all first order (before
    the Function, 7 of the 8 were second order: the albedo leaf reached
    the direction through the table); the bunny's stay second order,
    since the MLP and the matrix are leaves."""
    cfg = cornell.full_config().replace(resolution=(16, 16), max_raytrace=8)
    normal, material = _grad_step_routes(
        cornell.full_scene(CPU), cornell.sky(CPU), cornell.full_camera(CPU),
        cfg, ["albedo"])
    assert normal == {"kernel": 0, "autograd_first_order": 8,
                      "autograd_second_order": 0}
    assert material == {"plain_gather": 0, "function": 16}
    cfg = bunny.glass_config().replace(resolution=(8, 8), max_raytrace=8,
                                       samples_per_pixel=1)
    names = ["bunny_" + k for k in BunnyMLP._fields] + ["matrix", "albedo"]
    normal, material = _grad_step_routes(
        bunny.glass_scene(CPU), bunny.glass_environment(device=CPU),
        bunny.camera(1.0, CPU), cfg, names)
    assert normal == {"kernel": 0, "autograd_first_order": 0,
                      "autograd_second_order": 8}
    assert material == {"plain_gather": 0, "function": 16}
