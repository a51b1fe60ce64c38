"""The port's constructors build on the card unless asked for the CPU.

Every function that makes tensors from nothing takes ``device=None``, and
None is the card (``core/device.resolve``). With ``device="cpu"`` every one
builds on the CPU. Without a card, a constructor given no device raises
instead of returning CPU tensors; with one, its tensors are on the card.
Whether a card is present is decided inside the test.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.core import types as ttypes
from raytracingpbr_tpu_torch.models import bunny, cornell, demo
from raytracingpbr_tpu_torch.ops import ibl, scene, sdf

from .torch_helpers import CPU

_JAX_LIKE_CAMERA = types.SimpleNamespace(
    lookfrom=np.zeros(3, np.float32), lookat=np.ones(3, np.float32),
    vup=np.array([0, 1, 0], np.float32), vfov=np.float32(35.0),
    aspect=np.float32(1.0), aperture=np.float32(0.0), focus=np.float32(1.0))

CONSTRUCTORS = {
    "make_scene": lambda **kw: scene.make_scene(
        [scene.ObjectSpec(sdf.SHAPE.SPHERE)], **kw),
    "load_bunny": sdf.load_bunny,
    "make_rays": lambda **kw: ttypes.make_rays(4, **kw),
    "make_camera": ttypes.make_camera,
    "make_frame_state": lambda **kw: ttypes.make_frame_state(4, **kw),
    "black_sky": ibl.black_sky,
    "constant_sky": lambda **kw: ibl.constant_sky((0.1, 0.2, 0.3), **kw),
    "hdr_environment": lambda **kw: ibl.hdr_environment(
        np.ones((4, 2, 3), np.float32), **kw),
    "cornell.full_scene": cornell.full_scene,
    "cornell.sky": cornell.sky,
    "bunny.metal_scene": bunny.metal_scene,
    "bunny.camera": lambda **kw: bunny.camera(16 / 9, **kw),
    "bunny.glass_environment": bunny.glass_environment,
    "demo.engine_scene": demo.engine_scene,
    "demo.gradient_environment": demo.gradient_environment,
    "convert.camera_from_jax": lambda **kw: convert.camera_from_jax(
        _JAX_LIKE_CAMERA, **kw),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.nn.Module):
        return list(x.buffers())
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_build_on_the_card_unless_asked(name):
    make = CONSTRUCTORS[name]
    on_cpu = _tensors(make(device=CPU))
    assert on_cpu and all(t.device.type == "cpu" for t in on_cpu)
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in _tensors(make()))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_hdr_environment_follows_a_tensor_image():
    """A function handed tensors follows their device."""
    img = torch.ones((4, 2, 3))
    assert ibl.hdr_environment(img).image.device.type == "cpu"
