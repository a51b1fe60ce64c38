"""Neural-SDF bunny scene family (port of
``raytracingpbr_tpu/models/bunny.py``): metal, glass (the animated flagship)
and v2, their configs, camera and environments. The geometry is the
sin-activated MLP of ``ops/sdf.py``."""
from __future__ import annotations

from ..config import HitCriterion, OmegaPolicy, RenderConfig
from ..core.types import Camera, make_camera
from ..ops.ibl import Environment, hdr_environment, white_sky
from ..ops.scene import ObjectSpec, Scene, animate, make_scene
from ..ops.sdf import SHAPE
from .demo import synthetic_hdr


def _bunny_object(material_kw) -> ObjectSpec:
    # the -90 degree x rotation stands the bunny up
    return ObjectSpec(SHAPE.BUNNY, (0, 0, 0), (-90, 0, 0), (1, 1, 1),
                      **material_kw)


def metal_scene(device=None) -> Scene:
    return make_scene([_bunny_object(dict(
        albedo=(1.0, 0.77, 0.34), roughness=0.2, metallic=1.0,
        transmission=0.0, ior=1.5))], device=device)


def glass_scene(device=None) -> Scene:
    """Dielectric bunny: transmission 1, ior 1.5."""
    return make_scene([_bunny_object(dict(
        albedo=(0.9, 0.9, 0.9), roughness=0.0, metallic=0.0,
        transmission=1.0, ior=1.5))], device=device)


def metal_config(scale: int = 1) -> RenderConfig:
    """3840x2160 (divided by ``scale``), 4 spp, 128 bounces, 512 march
    trips, constant w 0.9, relative hit test."""
    return RenderConfig(
        resolution=(3840 // scale, 2160 // scale),
        samples_per_pixel=4,
        max_raytrace=128,
        max_raymarch=512,
        omega=0.9,
        omega_policy=OmegaPolicy.CONSTANT,
        hit_criterion=HitCriterion.RELATIVE,
        march_t0=0.005,
        black_background=True,
        f0_half=True,
    )


def glass_config(scale: int = 1) -> RenderConfig:
    """The glass animation: 1920x1080 (divided by ``scale``), 512 spp, 512
    bounces, 2048 march trips, constant w 0.5 for thin glass."""
    return RenderConfig(
        resolution=(1920 // scale, 1080 // scale),
        samples_per_pixel=512,
        max_raytrace=512,
        max_raymarch=2048,
        omega=0.5,
        omega_policy=OmegaPolicy.CONSTANT,
        hit_criterion=HitCriterion.RELATIVE,
        march_t0=0.005,
        f0_half=True,
    )


def camera(aspect: float, device=None) -> Camera:
    return make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                       vfov=35.0, aspect=aspect, aperture=0.01, focus=3.0,
                       device=device)


def v2_config(scale: int = 1) -> RenderConfig:
    """White background for primary misses, 4K, 12 spp."""
    return metal_config(scale).replace(samples_per_pixel=12,
                                       black_background=False)


def v2_environment(device=None) -> Environment:
    return white_sky(device=device)


def glass_environment(bilinear: bool = True, device=None) -> Environment:
    """HDR IBL with the sky gamma boost (synthetic map, seed 1)."""
    return hdr_environment(synthetic_hdr(seed=1), exposure=1.0, gamma=2.2,
                           bilinear=bilinear, device=device)


def animated_scene(scene: Scene, frame) -> Scene:
    """Per-frame spin and z-bob; ``frame`` may be a device tensor."""
    return animate(scene, frame)
