"""The self-goldens through the port's megakernel on the CPU, part one:
the port's golden specs (``raytracingpbr_tpu_torch/models/goldens.py``)
are ``tests/golden_specs.py``'s, and the four Cornell goldens score at
least 35 dB against ``assets/goldens/<name>.png`` (``tests/test_parity.py``'s
bar). ``tests/test_torch_goldens_scenes.py`` holds the other five."""
import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.models.goldens import GOLDENS

from .golden_specs import GOLDENS as JAX_GOLDENS
from .torch_helpers import CPU, golden_psnr, nn

BUFFERS = ("position", "scale", "matrix", "local_offset", "albedo",
           "emission", "roughness", "metallic", "transmission", "ior")


@pytest.mark.parametrize("name", sorted(JAX_GOLDENS))
def test_spec_matches_golden_specs(name):
    """Same config, samples, exposure, camera, sky and scene as the spec
    the goldens were rendered from."""
    assert sorted(GOLDENS) == sorted(JAX_GOLDENS)
    ref, got = JAX_GOLDENS[name](), GOLDENS[name](CPU)
    assert got["cfg"] == convert.config_from_jax(ref["cfg"])
    assert got["spp"] == ref["spp"]
    assert got.get("exposure", 1.0) == ref.get("exposure", 1.0)
    cam = convert.camera_from_jax(ref["cam"], CPU)
    for k in ("lookfrom", "lookat", "vup", "vfov", "aspect", "aperture",
              "focus"):
        torch.testing.assert_close(getattr(got["cam"], k), getattr(cam, k),
                                   rtol=0, atol=0)
    env = convert.environment_from_jax(ref["env"], CPU)
    assert (got["env"].kind, got["env"].bilinear) == (env.kind, env.bilinear)
    for k in ("image", "scale", "color_a", "color_b"):
        a, b = getattr(got["env"], k), getattr(env, k)
        assert (a is None) == (b is None), k
        if a is not None:  # the synthetic HDR map, to an f32 ulp
            torch.testing.assert_close(a, b, rtol=2.4e-7, atol=0)
    scene = convert.scene_from_jax(ref["scene"], CPU)
    assert got["scene"].shape_types == scene.shape_types
    for k in BUFFERS:
        np.testing.assert_allclose(nn(getattr(got["scene"], k)),
                                   nn(getattr(scene, k)), rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["cornell_minimal", "cornell_full",
                                  "cornell_v2", "cornell_v3"])
def test_megakernel_golden(name):
    db = golden_psnr(name)
    assert db >= 35.0, f"{name}: PSNR {db:.2f} dB"
