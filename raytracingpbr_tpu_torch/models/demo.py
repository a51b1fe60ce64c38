"""Demo scene family (port of ``raytracingpbr_tpu/models/demo.py``): the
engine's 7-object scene, the scene_demo variant, the engine / scene_demo /
tokyo configs and their skies, and the synthetic HDR map."""
from __future__ import annotations

import numpy as np

from ..config import HitCriterion, OmegaPolicy, RenderConfig, Tonemap
from ..core.types import Camera, make_camera
from ..ops.ibl import Environment, gradient_sky, hdr_environment
from ..ops.scene import ObjectSpec, Scene, make_scene
from ..ops.sdf import SHAPE


def engine_scene(device=None) -> Scene:
    """Ground sphere, emissive sphere, metal blue sphere, glass sphere, red
    cylinder, two metal boxes; box round radius 0.03."""
    objs = [
        ObjectSpec(SHAPE.SPHERE, (0, -100.501, 0), (0, 0, 0), (100,) * 3,
                   albedo=(0.6, 0.6, 0.6), roughness=1.0, metallic=1.0,
                   ior=1.100),
        ObjectSpec(SHAPE.SPHERE, (0, 0, 0), (0, 0, 0), (0.5,) * 3,
                   albedo=(0.9, 0.9, 0.9), emission=(1.0, 10.0, 1.0),
                   roughness=0.0, metallic=1.0, ior=1.0),
        ObjectSpec(SHAPE.SPHERE, (1, -0.2, 0), (0, 0, 0), (0.3,) * 3,
                   albedo=(0.18, 0.18, 0.9), roughness=0.2, metallic=1.0,
                   ior=1.100),
        ObjectSpec(SHAPE.SPHERE, (0.0, -0.2, 2), (0, 0, 0), (0.3,) * 3,
                   albedo=(0.9, 0.9, 0.9), roughness=0.0, metallic=0.0,
                   transmission=1.0, ior=1.5),
        ObjectSpec(SHAPE.CYLINDER, (-1.0, -0.2, 0), (0, 0, 0), (0.3,) * 3,
                   albedo=(0.9, 0.18, 0.18), roughness=0.0, metallic=0.0,
                   ior=1.460),
        ObjectSpec(SHAPE.BOX, (0, 0, 5), (0, 0, 0), (2, 1, 0.2),
                   albedo=(0.9, 0.9, 0.18), roughness=0.0, metallic=1.0,
                   ior=0.470),
        ObjectSpec(SHAPE.BOX, (0, 0, -2), (0, 0, 0), (2, 1, 0.2),
                   albedo=(0.9, 0.9, 0.9), roughness=0.0, metallic=1.0,
                   ior=2.950),
    ]
    return make_scene(objs, box_round=0.03, device=device)


def engine_config() -> RenderConfig:
    """The engine's defaults (``RenderConfig()``)."""
    return RenderConfig()


def engine_camera(device=None) -> Camera:
    """The live app's start pose."""
    cfg = RenderConfig()
    return make_camera(lookfrom=(0.0, -0.2, 4.0), lookat=(0.0, -0.2, 3.0),
                       vfov=35.0, aspect=cfg.width / cfg.height,
                       aperture=0.01, focus=4.0, device=device)


def scene_demo_scene(device=None) -> Scene:
    """scene_demo variant of the 7-object scene: green-emissive centre
    sphere, saturated albedos, sharp boxes."""
    objs = [
        ObjectSpec(SHAPE.SPHERE, (0, -100.501, 0), (0, 0, 0), (100,) * 3,
                   albedo=(0.6, 0.6, 0.6), roughness=1.0, metallic=1.0,
                   ior=1.635),
        ObjectSpec(SHAPE.SPHERE, (0, 0, 0), (0, 0, 0), (0.5,) * 3,
                   albedo=(1.0, 1.0, 1.0), emission=(1.0, 10.0, 1.0),
                   roughness=1.0, metallic=0.0, ior=1.0),
        ObjectSpec(SHAPE.SPHERE, (1, -0.2, 0), (0, 0, 0), (0.3,) * 3,
                   albedo=(0.2, 0.2, 1.0), roughness=0.2, metallic=1.0,
                   ior=1.100),
        ObjectSpec(SHAPE.SPHERE, (0.0, -0.2, 2), (0, 0, 0), (0.3,) * 3,
                   albedo=(0.9, 0.9, 0.9), roughness=0.0, metallic=0.0,
                   transmission=1.0, ior=1.5),
        ObjectSpec(SHAPE.CYLINDER, (-1.0, -0.2, 0), (0, 0, 0), (0.3,) * 3,
                   albedo=(1.0, 0.2, 0.2), roughness=0.0, metallic=0.0,
                   ior=1.460),
        ObjectSpec(SHAPE.BOX, (0, 0, 5), (0, 0, 0), (2, 1, 0.2),
                   albedo=(0.9, 0.9, 0.18), roughness=0.0, metallic=1.0,
                   ior=0.470),
        ObjectSpec(SHAPE.BOX, (0, 0, -2), (0, 0, 0), (2, 1, 0.2),
                   albedo=(0.9, 0.9, 0.9), roughness=0.0, metallic=1.0,
                   ior=2.950),
    ]
    return make_scene(objs, box_round=0.0, device=device)


def scene_demo_config() -> RenderConfig:
    """960x540 progressive demo: relative hit test, w 1.6 -> 1 rollback."""
    return RenderConfig(
        resolution=(1920 // 2, 1080 // 2),
        max_raytrace=512,
        max_raymarch=512,
        omega=1.6,
        omega_policy=OmegaPolicy.ROLLBACK_TO_ONE,
        hit_criterion=HitCriterion.RELATIVE,
        march_t0=0.005,
        tonemap=Tonemap.GAMMA_THEN_ACES,
    )


def gradient_environment(device=None) -> Environment:
    """Procedural sky x1.8."""
    return gradient_sky(scale=1.8, device=device)


def tokyo_config() -> RenderConfig:
    """Tokyo IBL demo: 2880x1620, half-up omega rollback."""
    return RenderConfig(
        resolution=(2880, 1620),
        max_raytrace=512,
        max_raymarch=512,
        omega=1.6,
        omega_policy=OmegaPolicy.ROLLBACK_HALF_UP,
        hit_criterion=HitCriterion.RELATIVE,
        march_t0=0.005,
    )


def synthetic_hdr(width: int = 192, height: int = 96,
                  seed: int = 0) -> np.ndarray:
    """Synthetic (W, H, 3) HDR map standing in for the reference's missing
    .hdr assets: sky gradient, a bright sun disk and a low-frequency colour
    ripple. numpy only; bit-identical to the JAX package's."""
    rng = np.random.default_rng(seed)
    x = (np.arange(width) + 0.5) / width
    y = (np.arange(height) + 0.5) / height
    xx, yy = np.meshgrid(x, y, indexing="ij")
    # vertical gradient: warm horizon to blue zenith (y=1 is up)
    base = (np.stack([1.0 - 0.5 * yy, 0.8 * np.ones_like(yy),
                      0.5 + 0.5 * yy], axis=-1))
    sun_x, sun_y = 0.3, 0.75
    d2 = (xx - sun_x) ** 2 + (yy - sun_y) ** 2
    sun = np.exp(-d2 / 0.002)[..., None] * np.array([50.0, 45.0, 35.0])
    ripple = 0.15 * np.sin(2 * np.pi * (3 * xx + 2 * yy))[..., None] \
        * rng.uniform(0.5, 1.0, size=(1, 1, 3))
    return (base + sun + ripple).astype(np.float32)


def tokyo_environment(bilinear: bool = False, device=None) -> Environment:
    """Tokyo-style HDR environment (synthetic map, exposure 1.8)."""
    return hdr_environment(synthetic_hdr(), exposure=1.8, gamma=2.2,
                           bilinear=bilinear, device=device)


def engine_environment(bilinear: bool = False, device=None) -> Environment:
    """The engine's HDR environment (synthetic map, exposure 1.4)."""
    return hdr_environment(synthetic_hdr(), exposure=1.4, gamma=2.2,
                           bilinear=bilinear, device=device)
