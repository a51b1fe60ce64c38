"""Port RNG parity: the counter hash is bit-exact against JAX, including
pixel ids near 2**32 and large step counters; the samplers agree to 1e-6
(they go through sin/cos/sqrt, whose last ulp differs between XLA and
PyTorch). CPU tensors take the plain draws; the CUDA kernel's constants
and its wrapper's host-side checks are held here too (the kernel itself
in ``tests/test_torch_kernel.py``, on the card)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracingpbr_tpu.core import rng as jrng
from raytracingpbr_tpu_torch.core import rng as trng
from raytracingpbr_tpu_torch.kernels import rng_kernel

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


# --- the CUDA kernel's dispatch, constants and host-side checks -------------

DRAWS = {"uniform4": (trng.uniform4, trng.uniform4_plain, 4),
         "uniform": (trng.uniform, trng.uniform_plain, 1),
         "r2_uniform4": (trng.r2_uniform4, trng.r2_uniform4_plain, 4)}


@pytest.mark.parametrize("name", sorted(DRAWS))
@pytest.mark.parametrize("step", [7, "lane"])
def test_cpu_draws_take_the_plain_path(name, step):
    """CPU tensors go to the plain draws, bit for bit, and launch
    nothing."""
    draw, plain, rows = DRAWS[name]
    pid = torch.arange(N, dtype=torch.int64) * 977
    if step == "lane":
        step = torch.arange(N, dtype=torch.int32) - N // 2
    rng_kernel.reset_launches()
    got, ref = draw(pid, step, 2, 1234567), plain(pid, step, 2, 1234567)
    got = (got,) if rows == 1 else got
    ref = (ref,) if rows == 1 else ref
    assert len(got) == len(ref) == rows
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.equal(g, r)
    assert rng_kernel.LAUNCHES == {"uniform4": 0, "r2_uniform4": 0}


def _cu_constants():
    src = (Path(trng.__file__).resolve().parent.parent / "csrc"
           / "rng.cu").read_text()
    return {m[1]: int(m[2], 0) for m in re.finditer(
        r"constexpr uint32_t (\w+) = (0x[0-9A-Fa-f]+|\d+)u;", src)}


@pytest.mark.parametrize("name,value", [
    ("PCG_MULT", trng._PCG_MULT), ("PCG_INC", trng._PCG_INC),
    ("R2_Y", trng._R2_Y)] + [(f"R2_A{k}", a) for k, a
                             in enumerate(trng._R2_A)])
def test_kernel_constants_are_the_plain_draws(name, value):
    """``csrc/rng.cu``'s words, read from the source, equal core/rng's."""
    assert _cu_constants()[name] == value


@pytest.mark.parametrize("step,kind,stride,value", [
    (5, rng_kernel.STEP_VALUE, 0, 5),
    (-1, rng_kernel.STEP_VALUE, 0, 2**32 - 1),
    (2**32 + 9, rng_kernel.STEP_VALUE, 0, 9),
    (np.int64(2**31 + 5), rng_kernel.STEP_VALUE, 0, 2**31 + 5),
    ("0-dim int64", rng_kernel.STEP_I64, 0, 0),
    ("lane int32", rng_kernel.STEP_I32, 1, 0),
    ("lane int64", rng_kernel.STEP_I64, 1, 0)])
def test_plan_takes_every_step_form(step, kind, stride, value):
    """The kernel's arguments for each form of ``step`` the port passes:
    an int by value (its low 32 bits), a one-element tensor read on its
    device, one step a lane; ``stream`` and ``seed`` as 32-bit words."""
    pid = torch.arange(N, dtype=torch.int32)
    tensors = {"0-dim int64": torch.tensor(-3),
               "lane int32": torch.zeros(N, dtype=torch.int32),
               "lane int64": torch.zeros(N, dtype=torch.int64)}
    step = tensors.get(step, step)
    p = rng_kernel.plan(pid, step, -2, 2**32 + 3, torch.float64)
    assert (p.n, p.step_kind, p.step_stride, p.step_value, p.stream,
            p.seed) == (N, kind, stride, value, 2**32 - 2, 3)
    assert (p.step is step) == (kind != rng_kernel.STEP_VALUE)


@pytest.mark.parametrize("args,error,match", [
    (dict(step=torch.zeros(3, dtype=torch.int64)), ValueError,
     "one element or"),
    (dict(step=torch.zeros((N, 1), dtype=torch.int64)), ValueError,
     "one element or"),
    (dict(step=torch.zeros(N)), TypeError, "int32 or int64 tensor"),
    (dict(step=1.5), TypeError, "an int or an integer tensor"),
    (dict(step=torch.zeros(N, dtype=torch.int64, device="meta")),
     ValueError, "step on meta"),
    (dict(step=torch.zeros((), dtype=torch.int64, device="meta")),
     ValueError, "step on meta"),
    (dict(step=torch.zeros(2 * N, dtype=torch.int64)[::2]), ValueError,
     "step: a contiguous"),
    (dict(pixel_id=torch.zeros(N)), TypeError, "pixel_id"),
    (dict(pixel_id=torch.arange(2 * N)[::2]), ValueError,
     "pixel_id: a contiguous"),
    (dict(stream=torch.tensor(2)), TypeError, "stream"),
    (dict(seed=1.0), TypeError, "seed"),
    (dict(dtype=torch.float16), TypeError, "float32 or float64")])
def test_plan_raises_on_what_the_kernel_does_not_take(args, error, match):
    kw = dict(pixel_id=torch.arange(N, dtype=torch.int64), step=7,
              stream=2, seed=0, dtype=torch.float32) | args
    with pytest.raises(error, match=match):
        rng_kernel.plan(**kw)


def test_draw_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        rng_kernel.draw(torch.arange(4), 0, 1)
