"""Cornell-box scene family (port of ``raytracingpbr_tpu/models/cornell.py``):
the same geometry, materials, configs and cameras."""
from __future__ import annotations

from ..config import HitCriterion, OmegaPolicy, RenderConfig, Roulette, Tonemap
from ..core.types import Camera, make_camera
from ..ops.ibl import Environment, black_sky
from ..ops.scene import ObjectSpec, Scene, make_scene
from ..ops.sdf import SHAPE

# 5 walls (position, rotation, scale, albedo), 2 boxes and the area light
_WALLS = [
    ((0, 0, -1), (0, 0, 0), (1, 1, 0.2), (0.4, 0.4, 0.4)),    # back
    ((0, 1, 0), (90, 0, 0), (1, 1, 0.2), (0.4, 0.4, 0.4)),    # ceiling
    ((0, -1, 0), (90, 0, 0), (1, 1, 0.2), (0.4, 0.4, 0.4)),   # floor
    ((-1, 0, 0), (0, 90, 0), (1, 1, 0.2), (0.5, 0.0, 0.0)),   # left red
    ((1, 0, 0), (0, 90, 0), (1, 1, 0.2), (0.0, 0.5, 0.0)),    # right green
]
_TALL_BOX = ((-0.275, -0.3, -0.2), (0.25, 0.5, 0.25))
_SMALL_BOX = ((0.275, -0.55, 0.2), (0, -197, 0), (0.25, 0.25, 0.25))
_LIGHT = ((0, 0.809, 0), (90, 0, 0), (0.2, 0.2, 0.01))


def minimal_scene(device=None) -> Scene:
    """8 sharp boxes with albedo + emission materials."""
    objs = [ObjectSpec(SHAPE.BOX, pos, rot, scale, albedo=alb)
            for pos, rot, scale, alb in _WALLS]
    objs.append(ObjectSpec(SHAPE.BOX, _TALL_BOX[0], (0, 112, 0), _TALL_BOX[1],
                           albedo=(0.4, 0.4, 0.4)))
    objs.append(ObjectSpec(SHAPE.BOX, *_SMALL_BOX, albedo=(0.4, 0.4, 0.4)))
    objs.append(ObjectSpec(SHAPE.BOX, *_LIGHT, albedo=(1.0, 1.0, 1.0),
                           emission=(100.0, 100.0, 100.0)))
    return make_scene(objs, box_round=0.0, device=device)


def minimal_config() -> RenderConfig:
    """512x512, 3 bounces, 256 march trips, absolute hit test."""
    return RenderConfig(
        resolution=(512, 512), max_raytrace=3, max_raymarch=256, omega=1.0,
        omega_policy=OmegaPolicy.CONSTANT,
        hit_criterion=HitCriterion.ABSOLUTE, hit_precision=1e-5,
        march_t0=0.0005, max_dis=2000.0, roulette=Roulette.EXP,
        light_quality=128.0, tonemap=Tonemap.GAMMA_THEN_ACES,
        visibility=(1e-6, 1e32))


def minimal_camera(device=None) -> Camera:
    return make_camera(lookfrom=(0.0, 0.0, 3.5), lookat=(0.0, 0.0, -1.0),
                       vfov=35.0, aspect=1.0, aperture=0.0, focus=1.0,
                       device=device)


def full_scene(device=None) -> Scene:
    """Full 6-parameter PBR Cornell box: rough dielectric walls (ior 1.53),
    light emission 100, 8 sharp boxes."""
    mat = dict(roughness=1.0, metallic=0.0, transmission=0.0, ior=1.53)
    objs = [ObjectSpec(SHAPE.BOX, pos, rot, scale, albedo=alb, **mat)
            for pos, rot, scale, alb in _WALLS]
    objs.append(ObjectSpec(SHAPE.BOX, _TALL_BOX[0], (0, -253, 0),
                           _TALL_BOX[1], albedo=(0.4, 0.4, 0.4), **mat))
    objs.append(ObjectSpec(SHAPE.BOX, *_SMALL_BOX, albedo=(0.4, 0.4, 0.4),
                           **mat))
    objs.append(ObjectSpec(SHAPE.BOX, *_LIGHT, albedo=(1.0, 1.0, 1.0),
                           emission=(100.0, 100.0, 100.0), roughness=1.0,
                           ior=1.0))
    return make_scene(objs, box_round=0.0, device=device)


def full_config() -> RenderConfig:
    """480x480, 128 bounces, 512 march trips, absolute precision 1e-4,
    constant omega 1."""
    return RenderConfig(
        resolution=(480, 480), max_raytrace=128, max_raymarch=512, omega=1.0,
        omega_policy=OmegaPolicy.CONSTANT,
        hit_criterion=HitCriterion.ABSOLUTE, hit_precision=1e-4,
        march_t0=0.005, max_dis=2000.0, roulette=Roulette.EXP,
        light_quality=128.0, tonemap=Tonemap.ACES_THEN_GAMMA,
        visibility=(1e-6, 1e32), f0_half=True)


def full_camera(device=None) -> Camera:
    return make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 2.0),
                       vfov=43.6, aspect=1.0, aperture=0.01, focus=4.0,
                       device=device)


def v2_scene(device=None) -> Scene:
    """Box-only Cornell at 10x world scale with a 0.01 round radius."""
    s10 = lambda v: tuple(10 * x for x in v)
    mat = dict(roughness=1.0, ior=1.53)
    objs = [ObjectSpec(SHAPE.BOX, s10(pos), rot, s10(scale), albedo=alb,
                       **mat) for pos, rot, scale, alb in _WALLS]
    objs.append(ObjectSpec(SHAPE.BOX, s10(_TALL_BOX[0]), (0, -253, 0),
                           s10(_TALL_BOX[1]), albedo=(0.4, 0.4, 0.4), **mat))
    objs.append(ObjectSpec(SHAPE.BOX, s10(_SMALL_BOX[0]), _SMALL_BOX[1],
                           s10(_SMALL_BOX[2]), albedo=(0.4, 0.4, 0.4),
                           **mat))
    objs.append(ObjectSpec(SHAPE.BOX, s10(_LIGHT[0]), _LIGHT[1],
                           s10(_LIGHT[2]), albedo=(1.0, 1.0, 1.0),
                           emission=(100.0, 100.0, 100.0), roughness=1.0,
                           ior=1.0))
    return make_scene(objs, box_round=0.01, device=device)


def v2_config() -> RenderConfig:
    return full_config().replace(max_raytrace=3, max_dis=20000.0,
                                 march_t0=0.05, hit_precision=1e-3)


def v3_config() -> RenderConfig:
    """Relative-error hit test with the w=1.6 -> 1 rollback (its march is
    kernel variant K1b: plain PyTorch only for now)."""
    return full_config().replace(
        omega=1.6, omega_policy=OmegaPolicy.ROLLBACK_TO_ONE,
        hit_criterion=HitCriterion.RELATIVE, march_t0=0.005)


def sky(device=None) -> Environment:
    """The Cornell megakernels' black sky."""
    return black_sky(device=device)
