"""Materials / BSDF shading (port of ``raytracingpbr_tpu/ops/shade.py``):
one branchless stochastic interaction (roughness-lerped microfacet normal,
Schlick Fresnel, reflect / refract / diffuse lobe choice)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..core import rng as rnglib
from ..core.math import dot, mix, normalize
from . import scene as scenelib
from .scene import Scene


def fresnel_schlick(no_i: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """Schlick: ``mix(|1 + NoI|^5, 1, F0)``."""
    return mix(torch.abs(1.0 + no_i) ** 5, 1.0, f0)


def fresnel_schlick_roughness(no_i, f0, roughness):
    """The example megakernels' roughness-remapped Schlick:
    ``mix(schlick, F0, roughness)``."""
    return mix(fresnel_schlick(no_i, f0), f0, roughness)


class Interaction(NamedTuple):
    direction: torch.Tensor    # (N, 3) new ray direction
    origin: torch.Tensor       # (N, 3) new ray origin
    color_scale: torch.Tensor  # (N, 3) throughput multiplier
    normal: torch.Tensor       # (N, 3) surface normal faced to the ray
    diffuse: torch.Tensor      # (N,) bool diffuse lobe chosen
    outer: torch.Tensor        # (N,) bool ray arrived from outside
    killed: torch.Tensor       # (N,) bool reflect_kill zeroed the path
    reflect: torch.Tensor      # (N,) bool reflect lobe chosen


def _col(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, None]


def ray_surface_interaction(scene: Scene, index: torch.Tensor,
                            position: torch.Tensor, direction: torch.Tensor,
                            u: tuple, cfg: RenderConfig,
                            roughness_fresnel: bool = False,
                            restart_at_hit: bool = False,
                            reflect_kill: Optional[bool] = None
                            ) -> Interaction:
    """Stochastic surface interaction at ``position`` of object ``index``.

    ``u``: four uniforms (hemisphere u/v, lobe u/v). ``roughness_fresnel``
    selects the example variant's Fresnel (and ``cfg.f0_half``);
    ``restart_at_hit`` restarts at the hit point instead of offsetting along
    the normal; ``reflect_kill`` (default: ``roughness_fresnel``) zeroes a
    below-surface reflection instead of folding it back above."""
    if reflect_kill is None:
        reflect_kill = roughness_fresnel
    mat = scenelib.materials_at(scene, index)
    albedo, roughness = mat.albedo, mat.roughness
    metallic, transmission, ior = mat.metallic, mat.transmission, mat.ior

    normal = scenelib.calc_normal(scene, index, position)
    outer = dot(direction, normal) < 0.0
    normal = torch.where(_col(outer), normal, -normal)

    alpha = (roughness * roughness)[:, None]
    hemi = rnglib.hemispheric(normal, u[0], u[1])
    rough_n = normalize(mix(normal, hemi, alpha))

    i = direction
    no_i = dot(rough_n, i)

    env_ior = cfg.env_ior
    eta = torch.where(outer, env_ior / ior, ior / env_ior)
    k = 1.0 - eta * eta * (1.0 - no_i * no_i)  # TIR when k < 0
    f0 = 2.0 * (eta - 1.0) / (eta + 1.0)
    f0 = f0 * f0
    if roughness_fresnel and cfg.f0_half:
        f0 = 0.5 * f0
    if roughness_fresnel:
        fr = fresnel_schlick_roughness(no_i, f0, roughness)
    else:
        fr = fresnel_schlick(no_i, f0)

    refl = i - 2.0 * no_i[:, None] * rough_n
    refl_outer = dot(refl, normal) < 0.0
    if not reflect_kill:
        refl = torch.where(_col(refl_outer), -refl, refl)

    k_safe = torch.clamp_min(k, 1e-12)
    refr = eta[:, None] * i - (torch.sqrt(k_safe) + eta * no_i)[:, None] \
        * rough_n

    take_reflect = (u[2] < fr + metallic) | (k < 0.0)
    take_refract = (~take_reflect) & (u[3] < transmission)
    new_dir = torch.where(_col(take_reflect), refl,
                          torch.where(_col(take_refract), refr, hemi))
    color_scale = albedo
    if reflect_kill:
        killed = take_reflect & refl_outer
        color_scale = color_scale * (~killed).to(albedo.dtype)[:, None]
    else:
        killed = torch.zeros_like(take_reflect)

    if restart_at_hit:
        new_origin = position
    else:
        leave_outer = dot(new_dir, normal) < 0.0
        offs = torch.where(leave_outer, -cfg.min_dis, cfg.min_dis)
        new_origin = position + normal * offs[:, None]

    return Interaction(new_dir, new_origin, color_scale, normal,
                       ~take_reflect & ~take_refract, outer, killed,
                       take_reflect)
