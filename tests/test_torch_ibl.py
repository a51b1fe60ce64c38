"""Port HDR environment against the JAX package.

The synthetic HDR map is numpy in both packages and must be bit-identical.
Lookups take 4096 seeded directions plus the poles and both sides of the
u = 0/1 seam; tolerance rtol 1e-5 (atol 1e-6): the same formulas, but
XLA-CPU's atan2/asin/pow and PyTorch's differ in the last ulps. The
port's environment is converted from JAX's, so both look up the same
texels.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core import math as jmath
from raytracingpbr_tpu.models import bunny as jbunny
from raytracingpbr_tpu.models import demo as jdemo
from raytracingpbr_tpu.ops import ibl as jibl
from raytracingpbr_tpu_torch.convert import environment_from_jax
from raytracingpbr_tpu_torch.core import math as tmath
from raytracingpbr_tpu_torch.models import bunny as tbunny
from raytracingpbr_tpu_torch.models import demo as tdemo
from raytracingpbr_tpu_torch.ops import ibl as tibl

from .torch_helpers import CPU, nn, tt


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _directions(n=4096, seed=0):
    """Seeded unit directions, then the poles and the seam (x < 0, z = +-0:
    atan2 gives +-pi there, u = 1 or 0)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    special = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                        [-1.0, 0.0, 0.0], [-1.0, 0.0, -0.0],
                        [-0.6, 0.8, 0.0], [-0.6, -0.8, -0.0],
                        [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return np.concatenate([d, special]).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(seed=1),
                                dict(width=37, height=19, seed=5)])
def test_synthetic_hdr_bit_identical(kw):
    got = tdemo.synthetic_hdr(**kw)
    ref = jdemo.synthetic_hdr(**kw)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_sample_spherical_map_matches_jax():
    d = _directions()
    _close(tmath.sample_spherical_map(tt(d)),
           jmath.sample_spherical_map(jnp.asarray(d)))


@pytest.mark.parametrize("exposure,gamma", [(1.4, 2.2), (1.8, 2.2),
                                            (1.0, 2.2), (0.7, 1.0)])
def test_hdr_environment_prebake_matches_jax(exposure, gamma):
    img = jdemo.synthetic_hdr()
    ref = jibl.hdr_environment(jnp.asarray(img), exposure=exposure,
                               gamma=gamma)
    got = tibl.hdr_environment(img, exposure=exposure, gamma=gamma,
                               device=CPU)
    assert got.kind == ref.kind == "hdr"
    _close(got.image, ref.image)
    _close(got.scale, ref.scale)
    raw = tibl.hdr_environment(img, prebake=False, device=CPU)
    np.testing.assert_array_equal(nn(raw.image), img)


@pytest.mark.parametrize("bilinear", [False, True])
def test_hdr_sky_color_matches_jax(bilinear):
    jenv = jdemo.tokyo_environment(bilinear=bilinear)
    env = environment_from_jax(jenv, CPU)
    assert env.bilinear == bilinear
    np.testing.assert_array_equal(nn(env.image), np.asarray(jenv.image))
    d = _directions(seed=1 + bilinear)
    ref = jibl.sky_color(jenv, jnp.asarray(d))
    got = tibl.sky_color(env, tt(d))
    _close(got, ref)


@pytest.mark.parametrize("name", ["glass", "tokyo", "engine"])
def test_model_environments_match_jax(name):
    make = {"glass": (jbunny.glass_environment, tbunny.glass_environment),
            "tokyo": (jdemo.tokyo_environment, tdemo.tokyo_environment),
            "engine": (jdemo.engine_environment,
                       tdemo.engine_environment)}[name]
    ref, got = make[0](), make[1](device=CPU)
    assert got.bilinear == ref.bilinear
    _close(got.image, ref.image)
    d = _directions(n=1024, seed=7)
    _close(tibl.sky_color(got, tt(d)), jibl.sky_color(ref, jnp.asarray(d)))
