"""The port's implicit hit-point VJP (``ops/march._hit_t``) and its
differentiable normal (``ops/scene.calc_normal``) against the JAX
package's on the CPU.

The same scene, rays, ``t``, index and hit mask go through both; JAX's
gradients come from ``jax.vjp`` of its ``_hit_t`` (a ``custom_vjp``) and
of its ``calc_normal`` (``jax.grad`` inside, so second order through the
SDF). The bar is rtol 1e-5 with an absolute floor of 1e-6 of the largest
magnitude (XLA-CPU contracts multiply-adds that PyTorch rounds apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingpbr_tpu as rt
from raytracingpbr_tpu.ops import march as jmarch
from raytracingpbr_tpu.ops import scene as jscene
from raytracingpbr_tpu.ops.scene import ObjectSpec as JSpec
from raytracingpbr_tpu.ops.sdf import SHAPE as JSHAPE
from raytracingpbr_tpu_torch import convert
from raytracingpbr_tpu_torch.ops import march as tmarch
from raytracingpbr_tpu_torch.ops import scene as tscene

from .torch_helpers import CPU, nn, tt

FIELDS = tscene._BUFFERS


def jax_scene():
    """One object of every analytic shape, turned and offset so that every
    transform buffer takes a gradient."""
    return rt.make_scene([
        JSpec(JSHAPE.SPHERE, (0.3, 0.2, -0.4), (10, 20, 30),
              (0.45, 0.45, 0.45)),
        JSpec(JSHAPE.BOX, (-0.6, -0.3, 0.2), (17, 35, -20),
              (0.3, 0.25, 0.35)),
        JSpec(JSHAPE.CYLINDER, (0.6, -0.5, 0.5), (0, 30, 90),
              (0.2, 0.3, 0.2)),
        JSpec(JSHAPE.CONE, (-0.2, 0.6, -0.2), (-40, 10, 5),
              (0.8, 0.6, 0.5)),
        JSpec(JSHAPE.PLANE, (0, -1.2, 0), (5, 0, 3), (1, 0, 1)),
    ])


def cfg():
    return rt.RenderConfig(
        resolution=(8, 8), max_raymarch=256, omega=1.0,
        omega_policy=rt.OmegaPolicy.CONSTANT,
        hit_criterion=rt.HitCriterion.ABSOLUTE, hit_precision=1e-5,
        march_t0=0.005, max_dis=50.0)


def rays(n=256, seed=0):
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.2, 3.5]) + rng.normal(0, 0.2, (n, 3))
    target = rng.uniform(-1.2, 1.2, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def grazing(scene_j):
    """Lanes whose ray is tangent to the sphere at the hit point, or tilted
    from it by 5e-7: |df/dt| under 1e-6, where the guard takes ``sign *
    1e-6 + 1e-12``."""
    c = np.asarray(scene_j.position)[0]
    r = float(np.asarray(scene_j.scale)[0, 0])
    t = np.float32(2.0)
    p = c + np.array([0.0, 0.0, r], np.float32)
    out_o, out_d = [], []
    for tilt in (0.0, 5e-7, -5e-7):
        d = np.array([1.0, 0.0, tilt], np.float32)
        d /= np.linalg.norm(d)
        out_o.append(p - t * d)
        out_d.append(d)
    return (np.array(out_o, np.float32), np.array(out_d, np.float32),
            np.full(3, t, np.float32))


def close(got, want, rtol=1e-5, floor=1e-6):
    want = np.asarray(want, np.float64)
    got = np.zeros_like(want) if got is None else nn(got).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * (np.abs(want).max() + 1e-30))


def test_hit_t_vjp_matches_jax():
    """Gradients to every scene buffer, the origin and the direction on
    hit lanes, miss lanes (zero) and grazing lanes (the |df/dt| guard)."""
    js = jax_scene()
    o, d = rays()
    c = cfg()
    res = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), c,
                       differentiable=False)
    t, idx, hit = (np.asarray(res.t), np.asarray(res.index),
                   np.asarray(res.hit))
    assert 0.2 < hit.mean() < 0.95  # both kinds of lane
    go, gd, gt = grazing(js)
    o = np.concatenate([o, go])
    d = np.concatenate([d, gd])
    t = np.concatenate([t, gt])
    idx = np.concatenate([idx, np.zeros(3, np.int32)])
    hit = np.concatenate([hit, np.ones(3, bool)])
    g = np.random.default_rng(1).normal(size=t.shape).astype(np.float32)

    _, vjp = jax.vjp(lambda sc, oo, dd: jmarch._hit_t(
        sc, oo, dd, jnp.asarray(t), jnp.asarray(idx), jnp.asarray(hit)),
        js, jnp.asarray(o), jnp.asarray(d))
    j_scene, j_o, j_d = vjp(jnp.asarray(g))

    ts = convert.scene_from_jax(js, CPU)
    leaves = [v.clone().requires_grad_(True) for v in tscene.params(ts)]
    sc = tscene.with_params(ts, leaves)
    to, td = tt(o).requires_grad_(True), tt(d).requires_grad_(True)
    got_t = tmarch._hit_t(sc, to, td, tt(t), tt(idx), tt(hit))
    np.testing.assert_array_equal(nn(got_t), t)  # the identity on t
    grads = torch.autograd.grad(got_t, leaves + [to, td], tt(g),
                                allow_unused=True)
    for name, gv in zip(FIELDS, grads):
        close(gv, getattr(j_scene, name))
    close(grads[-2], j_o)
    close(grads[-1], j_d)
    # the transforms do take gradients, miss lanes none, and the guard
    # gives the grazing lanes their large but finite coefficients
    assert np.abs(np.asarray(j_scene.position)).max() > 0
    assert np.abs(np.asarray(j_scene.matrix)).max() > 0
    miss = ~hit
    assert (nn(grads[-2])[miss] == 0).all()
    assert np.isfinite(nn(grads[-2])[-3:]).all()
    assert np.abs(nn(grads[-2])[-3]).max() > 1e5


def test_march_differentiable_attaches_hit_t():
    """``march(differentiable=True)``, the default: the same ``t`` as the
    detached march, with the implicit gradient to the scene and the rays
    equal to JAX's ``march``'s."""
    js = jax_scene()
    o, d = rays(64, seed=3)
    c = cfg()
    g = np.random.default_rng(2).normal(size=(64,)).astype(np.float32)

    def jf(sc, oo, dd):
        return jnp.sum(jmarch.march(sc, oo, dd, c).t * g)
    j_scene, j_o, j_d = jax.grad(jf, argnums=(0, 1, 2))(
        js, jnp.asarray(o), jnp.asarray(d))

    ts = convert.scene_from_jax(js, CPU)
    leaves = [v.clone().requires_grad_(True) for v in tscene.params(ts)]
    sc = tscene.with_params(ts, leaves)
    to, td = tt(o).requires_grad_(True), tt(d).requires_grad_(True)
    tc = convert.config_from_jax(c)
    res = tmarch.march(sc, to, td, tc)
    plain = tmarch.march(ts, tt(o), tt(d), tc, differentiable=False)
    assert torch.equal(res.t.detach(), plain.t)
    assert res.t.grad_fn is not None and plain.t.grad_fn is None
    grads = torch.autograd.grad((res.t * tt(g)).sum(), leaves + [to, td],
                                allow_unused=True)
    for name, gv in zip(FIELDS, grads):
        close(gv, getattr(j_scene, name), rtol=1e-4)
    close(grads[-2], j_o, rtol=1e-4)
    close(grads[-1], j_d, rtol=1e-4)


@pytest.mark.parametrize("field", FIELDS)
def test_only_sdf_buffers_attach_the_hit_point(field):
    """With one buffer requiring grad, ``march`` records the hit-point VJP
    and the normal's second order only if the SDF reads that buffer: a
    material-only graph keeps the first-order normal, as JAX's VJPs to the
    materials there are zeros. Either way the numbers are the forward's."""
    ts = convert.scene_from_jax(jax_scene(), CPU)
    sc = ts.replace(**{field: getattr(ts, field).clone().requires_grad_()})
    o, d = rays(64, seed=3)
    tc = convert.config_from_jax(cfg())
    res = tmarch.march(sc, tt(o), tt(d), tc)
    normal = tscene.calc_normal(sc, res.index, res.position)
    geometry = field in tscene._SDF_BUFFERS
    assert (res.t.grad_fn is not None) == geometry
    assert normal.requires_grad == geometry
    plain = tmarch.march(ts, tt(o), tt(d), tc, differentiable=False)
    assert torch.equal(res.t.detach(), plain.t)
    assert torch.equal(normal.detach(),
                       tscene.calc_normal(ts, plain.index, plain.position))


@pytest.mark.parametrize("hit_only", [True, False])
def test_calc_normal_second_order_matches_jax(hit_only):
    """The normal's VJP in the scene and the point: the port's
    ``create_graph`` gradient against ``jax.vjp`` of JAX's ``calc_normal``
    (a ``jax.grad`` inside, so second order). On surface points of every
    shape, and on points off the surfaces."""
    js = jax_scene()
    o, d = rays(128, seed=4)
    res = jmarch.march(js, jnp.asarray(o), jnp.asarray(d), cfg(),
                       differentiable=False)
    idx = np.asarray(res.index)
    p = np.asarray(res.position)
    if not hit_only:
        p = p + np.random.default_rng(5).normal(0, 0.05, p.shape).astype(
            np.float32)
    keep = np.isfinite(p).all(-1) & (np.abs(p) < 10).all(-1)
    p, idx = p[keep], idx[keep]
    cot = np.random.default_rng(6).normal(size=p.shape).astype(np.float32)

    n_j, vjp = jax.vjp(lambda sc, q: jscene.calc_normal(sc, jnp.asarray(idx),
                                                        q),
                       js, jnp.asarray(p))
    j_scene, j_p = vjp(jnp.asarray(cot))

    ts = convert.scene_from_jax(js, CPU)
    leaves = [v.clone().requires_grad_(True) for v in tscene.params(ts)]
    sc = tscene.with_params(ts, leaves)
    tp = tt(p).requires_grad_(True)
    n_t = tscene.calc_normal(sc, tt(idx), tp)
    np.testing.assert_allclose(nn(n_t), np.asarray(n_j), rtol=1e-5,
                               atol=1e-6)
    grads = torch.autograd.grad(n_t, leaves + [tp], tt(cot),
                                allow_unused=True)
    for name, gv in zip(FIELDS, grads):
        close(gv, getattr(j_scene, name), rtol=1e-4, floor=1e-5)
    close(grads[-1], j_p, rtol=1e-4, floor=1e-5)
    assert np.abs(np.asarray(j_scene.matrix)).max() > 0
    # a forward call (nothing requires grad) keeps the detached normal
    plain = tscene.calc_normal(ts, tt(idx), tt(p))
    assert plain.grad_fn is None
    assert torch.equal(plain, n_t.detach())
