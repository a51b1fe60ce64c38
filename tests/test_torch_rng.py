"""Port RNG parity: the counter hash is bit-exact against JAX, including
pixel ids near 2**32 and large step counters; the samplers agree to 1e-6
(they go through sin/cos/sqrt, whose last ulp differs between XLA and
PyTorch)."""
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu_torch.core import rng as trng

from .torch_helpers import nn, tt

N = 4096


def _words(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=(4, N), dtype=np.uint64)
    w[:, :8] = 2**32 - 1 - np.arange(8)  # the top of the range
    w[:, 8:16] = np.arange(8)
    return w.astype(np.uint32)


def test_pcg4d_bit_exact():
    w = _words(0)
    ref = jrng.pcg4d(*(jnp.asarray(v) for v in w))
    got = trng.pcg4d(*(tt(v.astype(np.int64)) for v in w))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(nn(g).astype(np.uint32), np.asarray(r))
        assert nn(g).min() >= 0 and nn(g).max() < 2**32


@pytest.mark.parametrize("step", [0, 7, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("stream,seed", [(0, 0), (2, 1234567)])
def test_uniform4_bit_exact(step, stream, seed):
    pid = np.concatenate([np.arange(N // 2, dtype=np.uint32),
                          (2**32 - 1 - np.arange(N // 2)).astype(np.uint32)])
    ref = jrng.uniform4(jnp.asarray(pid), jnp.uint32(step), stream, seed)
    got = trng.uniform4(tt(pid.astype(np.int64)), step, stream, seed)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(nn(g), np.asarray(r))
    np.testing.assert_array_equal(
        nn(trng.uniform(tt(pid.astype(np.int64)), step, stream, seed)),
        np.asarray(ref[0]))


def test_r2_uniform4_bit_exact():
    rng = np.random.default_rng(1)
    pid = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    counter = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    ref = jrng.r2_uniform4(jnp.asarray(pid), jnp.asarray(counter), 1, 9)
    got = trng.r2_uniform4(tt(pid.astype(np.int64)),
                           tt(counter.astype(np.int64)), 1, 9)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(nn(g), np.asarray(r))


def test_samplers_match():
    rng = np.random.default_rng(2)
    u1, u2 = rng.random((2, N), dtype=np.float32)
    normal = rng.normal(size=(N, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    pairs = [
        (jrng.in_unit_disk(jnp.asarray(u1), jnp.asarray(u2)),
         trng.in_unit_disk(tt(u1), tt(u2))),
        (jrng.in_unit_sphere(jnp.asarray(u1), jnp.asarray(u2)),
         trng.in_unit_sphere(tt(u1), tt(u2))),
        (jrng.hemispheric(jnp.asarray(normal), jnp.asarray(u1),
                          jnp.asarray(u2)),
         trng.hemispheric(tt(normal), tt(u1), tt(u2))),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(nn(got), np.asarray(ref), rtol=0,
                                   atol=1e-6)
