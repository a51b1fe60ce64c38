"""The self-golden render specs, one per reference workload family (the
port's copy of ``tests/golden_specs.py``, built from the port's models).

Each spec renders ``assets/goldens/<name>.png`` through the megakernel
(:func:`render_golden`) at a size scaled down from the family's config;
the scene, materials, sky and tonemap are the family's own. The goldens
were rendered by the JAX package; a port render must score at least 35 dB
against them.
"""
from __future__ import annotations

from ..core.types import make_camera
from ..ops.integrator import render_image
from . import bunny, cornell, demo


def _cornell_minimal(device):
    cfg = cornell.minimal_config().replace(resolution=(64, 64),
                                           max_raymarch=128, max_raytrace=8)
    return dict(scene=cornell.minimal_scene(device), env=cornell.sky(device),
                cam=cornell.minimal_camera(device), cfg=cfg, spp=8,
                exposure=0.6)


def _cornell_full(device):
    cfg = cornell.full_config().replace(resolution=(64, 64),
                                        max_raymarch=160, max_raytrace=12)
    return dict(scene=cornell.full_scene(device), env=cornell.sky(device),
                cam=cornell.full_camera(device), cfg=cfg, spp=8, exposure=0.6)


def _cornell_v2(device):
    cfg = cornell.v2_config().replace(resolution=(64, 64), max_raymarch=128)
    cam = make_camera(lookfrom=(0, 0, 30), lookat=(0, 0, 20), vfov=43.6,
                      aspect=1.0, aperture=0.01, focus=4.0, device=device)
    return dict(scene=cornell.v2_scene(device), env=cornell.sky(device),
                cam=cam, cfg=cfg, spp=8, exposure=0.6)


def _cornell_v3(device):
    cfg = cornell.v3_config().replace(resolution=(64, 64),
                                      max_raymarch=128, max_raytrace=8)
    return dict(scene=cornell.full_scene(device), env=cornell.sky(device),
                cam=cornell.full_camera(device), cfg=cfg, spp=8, exposure=0.6)


def _bunny_metal(device):
    cfg = bunny.metal_config(scale=40).replace(max_raymarch=128,
                                               max_raytrace=8)
    return dict(scene=bunny.metal_scene(device),
                env=bunny.glass_environment(device=device),
                cam=bunny.camera(cfg.width / cfg.height, device), cfg=cfg,
                spp=6)


def _bunny_v2(device):
    cfg = bunny.v2_config(scale=40).replace(max_raymarch=128, max_raytrace=8)
    return dict(scene=bunny.glass_scene(device),
                env=bunny.v2_environment(device=device),
                cam=bunny.camera(cfg.width / cfg.height, device), cfg=cfg,
                spp=6)


def _bunny_glass_anim(device):
    cfg = bunny.glass_config(scale=40).replace(max_raymarch=128,
                                               max_raytrace=8)
    scene = bunny.animated_scene(bunny.glass_scene(device), 12.0)
    return dict(scene=scene, env=bunny.glass_environment(device=device),
                cam=bunny.camera(cfg.width / cfg.height, device), cfg=cfg,
                spp=6)


def _scene_demo(device):
    cfg = demo.scene_demo_config().replace(resolution=(64, 36),
                                           max_raymarch=128, max_raytrace=8)
    return dict(scene=demo.scene_demo_scene(device),
                env=demo.gradient_environment(device=device),
                cam=demo.engine_camera(device), cfg=cfg, spp=6)


def _tokyo(device):
    cfg = demo.tokyo_config().replace(resolution=(64, 36),
                                      max_raymarch=128, max_raytrace=8)
    return dict(scene=demo.engine_scene(device),
                env=demo.tokyo_environment(device=device),
                cam=demo.engine_camera(device), cfg=cfg, spp=6)


# name -> spec factory(device); the names of assets/goldens/<name>.png
GOLDENS = {
    "cornell_minimal": _cornell_minimal,
    "cornell_full": _cornell_full,
    "cornell_v2": _cornell_v2,
    "cornell_v3": _cornell_v3,
    "bunny_metal": _bunny_metal,
    "bunny_v2": _bunny_v2,
    "bunny_glass_anim": _bunny_glass_anim,
    "scene_demo": _scene_demo,
    "tokyo": _tokyo,
}


def render_golden(name: str, device=None):
    """A family's golden image through the megakernel: (H, W, 3) floats in
    [0, 1], on ``device`` (the card unless given the CPU)."""
    spec = GOLDENS[name](device)
    return render_image(spec["scene"], spec["env"], spec["cam"], spec["cfg"],
                        spp=spec["spp"], exposure=spec.get("exposure", 1.0))
