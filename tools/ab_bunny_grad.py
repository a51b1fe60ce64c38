"""Side-by-side probes of the bunny's gradient path and of reprojection's
card-against-CPU bits, on one NVIDIA card (imports no jax):

    PYTHONPATH=. python3 tools/ab_bunny_grad.py [reproject|spread|recovery]

* ``reproject``: ``ops/reproject.reproject`` on the card against the CPU on
  ``tests/test_torch_kernel.py``'s 64x48 Cornell state, with the pixel
  centres divided by host ints or by tensors on the device, the lengths
  from ``linalg.vector_norm`` or from squares summed in order, and the
  roots in float32 or from float64: the share of depths (``hit_t``) and
  of pixel-centre directions bit-equal each way; then each intermediate of
  the module's own ``pixel_center_rays``.
* ``spread``: ``chip_smoke.py`` 8f's step (the glass bunny at 1920x1080, 8
  bounces, the MSE against zeros) with K1c at two samples, with K1d, and
  on the 240x135 crop with the plain march, each gradient's difference
  from K1c's (norm over norm); and the hit lanes of one step's march
  calls by |df/dt| at the hit point.
* ``recovery``: 8g's MLP recovery at 64x36 (the absolute 1e-4 hit test)
  under three skies (the gradient sky, the glass sky clipped at 2 before
  its gamma, i.e. without its sun, and the glass sky): the loss of a
  fixed-sample render at five output-bias shifts, autograd's derivative
  in the bias against central differences, and 30 train steps with
  ``param_mask(set())`` (Adam at 1e-3 and 3e-4, Adam on the bias alone,
  SGD).

With no argument all three run. Prints the card's name and power limit.
"""
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from raytracingpbr_tpu_torch.config import HitCriterion
from raytracingpbr_tpu_torch.core.math import dot
from raytracingpbr_tpu_torch.core.types import make_camera, make_frame_state
from raytracingpbr_tpu_torch.models import bunny, cornell
from raytracingpbr_tpu_torch.models.demo import synthetic_hdr
from raytracingpbr_tpu_torch.ops import ibl, march
from raytracingpbr_tpu_torch.ops import reproject as rp
from raytracingpbr_tpu_torch.ops import scene as scenelib
from raytracingpbr_tpu_torch.ops.integrator import render_frame
from raytracingpbr_tpu_torch.parallel import train as ptrain


def reproject_bits(dev):
    cpu = torch.device("cpu")
    cfg = cornell.minimal_config().replace(resolution=(64, 48),
                                           max_raytrace=8)
    state = make_frame_state(cfg.num_pixels, dev)
    scene, env = cornell.minimal_scene(dev), cornell.sky(dev)
    cam = cornell.minimal_camera(dev)
    for _ in range(4):
        _, state = render_frame(scene, env, cam, state, cfg)
    moved = lambda d: make_camera(lookfrom=(0.03, 0.0, 3.4),
                                  lookat=(0.0, 0.0, -1.0), vfov=40.0,
                                  aspect=cfg.width / cfg.height, device=d)
    state_c = cs.to_cpu(state)
    cam_c = cornell.minimal_camera(cpu)
    own = (rp.pixel_center_rays, rp._unit, rp._sqrt)

    def centres(host_ints):
        def pixel_center_rays(c, cf):
            if not host_ints:
                return own[0](c, cf)
            hw, hh = rp._half_extent(c)
            x, y, z = rp.camera_basis(c)
            pid = torch.arange(cf.num_pixels, device=c.lookfrom.device)
            u = ((pid // cf.height).to(c.lookfrom.dtype) + 0.5) / cf.width
            v = ((pid % cf.height).to(c.lookfrom.dtype) + 0.5) / cf.height
            d = ((2.0 * u - 1.0)[:, None] * (hw * x)
                 + (2.0 * v - 1.0)[:, None] * (hh * y) - z)
            return c.lookfrom, rp._unit(d)
        return pixel_center_rays
    norm = lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    f32 = torch.sqrt
    ways = {"host ints, vector_norm, f32 sqrt (PR 10)": (True, norm, f32),
            "device divisors, vector_norm, f32 sqrt": (False, norm, f32),
            "device divisors, ordered sum, f32 sqrt": (False, None, f32),
            "device divisors, ordered sum, f64 sqrt (the module)": (
                False, None, None)}
    try:
        for label, (host, unit, sqrt) in ways.items():
            rp.pixel_center_rays = centres(host)
            rp._unit = unit or own[1]
            rp._sqrt = sqrt or own[2]
            got = rp.reproject(state, cam, moved(dev), cfg)
            ref = rp.reproject(state_c, cam_c, moved(cpu), cfg)
            d_g = rp.pixel_center_rays(cam, cfg)[1].cpu()
            d_c = rp.pixel_center_rays(cam_c, cfg)[1]
            t_eq = float((got.hit_t.cpu() == ref.hit_t).float().mean())
            cs.log(f"[reproject] {label}: hit_t bit-equal on {t_eq:.4f} of "
                   f"pixels, directions on "
                   f"{float((d_g == d_c).all(1).float().mean()):.4f}")
    finally:
        rp.pixel_center_rays, rp._unit, rp._sqrt = own

    def steps(c):
        hw, hh = rp._half_extent(c)
        x, y, z = rp.camera_basis(c)
        dv, dt = c.lookfrom.device, c.lookfrom.dtype
        pid = torch.arange(cfg.num_pixels, device=dv)
        w, h = (torch.full((), float(k), dtype=dt, device=dv)
                for k in (cfg.width, cfg.height))
        out = dict(u=((pid // cfg.height).to(dt) + 0.5) / w,
                   v=((pid % cfg.height).to(dt) + 0.5) / h)
        out["d"] = ((2.0 * out["u"] - 1.0)[:, None] * (hw * x)
                    + (2.0 * out["v"] - 1.0)[:, None] * (hh * y) - z)
        out["squares summed"] = dot(out["d"], out["d"])
        out["f32 sqrt"] = torch.sqrt(out["squares summed"])
        out["f64 sqrt"] = rp._sqrt(out["squares summed"])
        return out
    g, c = steps(cam), steps(cam_c)
    cs.log("[reproject] pixel_center_rays' steps, card against CPU, share "
           "bit-equal: " + ", ".join(
               f"{k} {float((g[k].cpu() == c[k]).float().mean()):.4f}"
               for k in g))


def spread(dev):
    scene, env = bunny.glass_scene(dev), bunny.glass_environment(device=dev)
    base = bunny.glass_config().replace(max_raytrace=8)
    cam = bunny.camera(base.width / base.height, dev)
    fields = cs.BUNNY_GRAD_FIELDS
    step = lambda s, cfg=base, pid=None: cs.bunny_step(scene, env, cam, cfg,
                                                       s, pid)
    show = lambda label, a, b: cs.log(
        f"[spread] {label}: " + ", ".join(
            f"{k} {cs.rel_diff(a[k], b[k]):.3e}" for k in fields))
    k4 = step(4)
    show("whole frame, K1c at sample 3 against sample 4", step(3), k4)
    show("whole frame, K1c at sample 4 run again", step(4), k4)
    mxu = base.replace(bunny_mxu=True)
    show("whole frame, K1d against K1c, sample 4", step(4, mxu), k4)
    w, h = cs.BUNNY_CROP
    x0, y0 = (base.width - w) // 2, (base.height - h) // 2
    crop = (torch.arange(x0, x0 + w, device=dev)[:, None] * base.height
            + torch.arange(y0, y0 + h, device=dev)[None, :]).reshape(-1)
    k3 = step(3, base, crop)
    show("crop, K1c's plain march against K1c",
         cs.with_march(lambda: step(3, base, crop), cs.plain_march), k3)
    d3 = step(3, mxu, crop)
    show("crop, K1d against K1c", d3, k3)
    show("crop, K1d's plain march against K1d",
         cs.with_march(lambda: step(3, mxu, crop), cs.plain_march), d3)
    show("crop, K1c at sample 4 against sample 3", step(4, base, crop), k3)
    bins = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
    for cfg in (base, mxu):
        _, calls = cs.record_as_made(lambda: step(4, cfg))
        hits, under = 0, [0] * len(bins)
        for call in calls:
            o, d, a, i = call["whole"]
            sc = call["scene"]
            r = march.ResumableResult(*cs.march_kernel.march_resumable_cuda(
                sc, o, d, call["cfg"], active=a, init=i))
            sel = r.hit if a is None else r.hit & a
            q = (o + r.t[:, None] * d)[sel].requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(scenelib.sd_object(
                    sc, r.index[sel], q).sum(), q)
            dfdt = dot(g, d[sel]).abs()
            hits += int(sel.sum())
            under = [n + int((dfdt < b).sum()) for n, b in zip(under, bins)]
        cs.log(f"[spread] {cs.march_kernel.variant(scene, cfg).upper()}, "
               f"one step's {len(calls)} calls: {hits} hit lanes, |df/dt| "
               f"under " + ", ".join(f"{b:g}: {n}"
                                     for b, n in zip(bins, under)))


def recovery(dev):
    true = bunny.glass_scene(dev)
    skies = {
        "gradient sky": ibl.gradient_sky(device=dev),
        "glass sky without its sun": ibl.hdr_environment(
            np.minimum(synthetic_hdr(seed=1), 2.0), exposure=1.0, gamma=2.2,
            bilinear=True, device=dev),
        "glass sky": bunny.glass_environment(device=dev)}
    cfg = bunny.glass_config().replace(
        resolution=cs.BUNNY_RECOVERY_RES, max_raytrace=8,
        hit_criterion=HitCriterion.ABSOLUTE, hit_precision=1e-4)
    cam = bunny.camera(cfg.width / cfg.height, dev)
    pid = torch.arange(cfg.num_pixels, device=dev)
    b0 = true.bunny.bias_out
    shifted = lambda x: true.replace(bunny=true.bunny._replace(
        bias_out=b0 + x))
    mask = ptrain.param_mask(set())

    def bias_only(g):
        m = mask(g).bunny
        return mask(g).replace(bunny=type(m)(*(
            v if k == "bias_out" else torch.zeros_like(v)
            for k, v in zip(m._fields, m))))
    sgd = lambda lr: lambda ts: (torch.optim.SGD(ts, lr=lr), None)
    adam = lambda lr: ptrain.adam(ptrain.cosine_decay_schedule(
        lr, cs.BUNNY_RECOVERY_STEPS, alpha=0.05))
    runs = [("Adam 1e-3", adam(1e-3), mask), ("Adam 3e-4", adam(3e-4), mask),
            ("Adam 1e-3, the bias alone", adam(1e-3), bias_only)]
    for name, env in skies.items():
        target = ptrain.render_pixels(true, env, cam, pid, cfg,
                                      spp=cs.BUNNY_TARGET_SPP,
                                      sample_offset=10_000,
                                      differentiable=False)

        def loss(x, grad=False):
            img = ptrain.render_pixels(shifted(x), env, cam, pid, cfg,
                                       spp=64, differentiable=grad)
            return torch.mean((img - target) ** 2)
        with torch.no_grad():
            scan = {x: float(loss(x)) for x in (-0.02, -0.01, 0.0, 0.01,
                                                0.02)}
        x = torch.tensor(0.01, device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(loss(x, True), x)
        with torch.no_grad():
            fd = (float(loss(0.012)) - float(loss(0.008))) / 0.004
        cs.log(f"[recovery] {name}: fixed-sample loss (64 spp) by bias "
               f"shift " + ", ".join(f"{k:+g} {v:.4e}"
                                     for k, v in scan.items())
               + f"; at +0.01 autograd {float(g):.4e}, central difference "
               f"(2e-3) {fd:.4e}")
        extra = [("SGD 1e-9", sgd(1e-9), mask)] if name == "glass sky" else []
        for label, opt, filt in runs + extra:
            step = ptrain.make_sharded_train_step(
                env, cam, cfg, spp=cs.BUNNY_RECOVERY_SPP, param_filter=filt)
            ts = ptrain.make_train_state(shifted(cs.BUNNY_BIAS_SHIFT), opt)
            t0, losses = time.perf_counter(), []
            for _ in range(cs.BUNNY_RECOVERY_STEPS):
                ts, ls = step(ts, target)
                losses.append(float(ls))
            gap = float(ts.scene.bunny.bias_out - b0)
            last = statistics.mean(losses[-10:])
            cs.log(f"[recovery] {name}, {label}: "
                   f"{time.perf_counter() - t0:.1f} s; loss {losses[0]:.4e} "
                   f"-> {last:.4e} (last ten), {losses[0] / last:.2f}x; "
                   f"bias - true {cs.BUNNY_BIAS_SHIFT} -> {gap:.5f}")


def main(argv):
    dev = cs.phase_device()
    cs.phase_build()
    what = argv[0] if argv else "all"
    for name, fn in (("reproject", reproject_bits), ("spread", spread),
                     ("recovery", recovery)):
        if what in (name, "all"):
            fn(dev)
    cs.log(cs.card_line())


if __name__ == "__main__":
    main(sys.argv[1:])
