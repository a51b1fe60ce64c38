"""Materials / BSDF shading (port of ``raytracingpbr_tpu/ops/shade.py``):
one branchless stochastic interaction (roughness-lerped microfacet normal,
Schlick Fresnel, reflect / refract / diffuse lobe choice), and the lobe
probabilities and densities that next-event estimation weighs its
environment draws with (``diffuse_lobe_prob``, ``specular_env_density``)."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..core import rng as rnglib
from ..core.math import dot, mix, normalize
from ..utils.profiling import traced
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


def _p_reflect(no_i, outer, roughness, metallic, ior, cfg: RenderConfig,
               roughness_fresnel: bool) -> torch.Tensor:
    """The lobe roulette's probability of reflecting at a microfacet whose
    cosine with the incident ray is ``no_i`` (1 under total internal
    reflection)."""
    env_ior = cfg.env_ior
    eta = torch.where(outer, env_ior / ior, ior / env_ior)
    k = 1.0 - eta * eta * (1.0 - no_i * no_i)
    f0 = 2.0 * (eta - 1.0) / (eta + 1.0)
    f0 = f0 * f0
    if roughness_fresnel and cfg.f0_half:
        f0 = 0.5 * f0
    if roughness_fresnel:
        fr = fresnel_schlick_roughness(no_i, f0, roughness)
    else:
        fr = fresnel_schlick(no_i, f0)
    return torch.where(k < 0.0, 1.0, torch.clamp(fr + metallic, 0.0, 1.0))


def diffuse_lobe_prob(scene: Scene, index: torch.Tensor,
                      direction: torch.Tensor, normal: torch.Tensor,
                      outer: torch.Tensor, omega_l: torch.Tensor,
                      cfg: RenderConfig,
                      roughness_fresnel: bool = False) -> torch.Tensor:
    """P(the diffuse lobe is chosen | the hemisphere draw landed on
    ``omega_l``). The roulette's Fresnel term is taken at the microfacet
    proxy of that draw, so the choice is correlated with the direction; an
    NEE estimate of the diffuse lobe's environment integral carries this
    conditional probability. ``normal`` is the incident-faced normal and
    ``outer`` the sidedness, both from the interaction."""
    mat = scenelib.materials_at(scene, index)
    alpha = (mat.roughness * mat.roughness)[:, None]
    rough_n = normalize(mix(normal, omega_l, alpha))
    p_reflect = _p_reflect(dot(rough_n, direction), outer, mat.roughness,
                           mat.metallic, mat.ior, cfg, roughness_fresnel)
    return (1.0 - p_reflect) * (1.0 - torch.clamp(mat.transmission, 0.0,
                                                  1.0))


def _halfway(omega, direction, normal):
    """The reflect lobe's admissible halfway vector of ``omega``: the unit
    vector along ``omega - i`` turned to the normal's side (guarded where
    ``omega == i`` and on the horizontal sign boundary)."""
    diff = omega - direction
    nrm = torch.sqrt(torch.clamp_min((diff * diff).sum(-1, keepdim=True),
                                     1e-24))
    m = diff / nrm
    s = torch.sign(dot(m, normal))
    return m * torch.where(s == 0.0, 1.0, s)[:, None]


def _reflect_density_raw(direction, normal, alpha, omega):
    """Solid-angle density at ``omega`` of the raw reflect-lobe map: a
    cosine-hemisphere draw ``h``, the proxy ``m = normalize((1-a) n + a h)``
    and the reflection ``w = i - 2 (m.i) m``. Inverting through the halfway
    vector (``dw = 4 |m.i| dm``) and the blend (``k = c (m.n) +
    sqrt(c^2 ((m.n)^2 - 1) + a^2)``, ``c = 1 - a``) gives

        p(w) = (h.n) k^2 / (pi a^2 (m.h) 4 |m.i|),

    0 where the inversion has no solution. ``alpha`` is clamped away from
    0."""
    dtype = direction.dtype
    a = torch.clamp_min(alpha, 1e-6)
    c = 1.0 - a
    m = _halfway(omega, direction, normal)
    mn = dot(m, normal)
    disc = c * c * (mn * mn - 1.0) + a * a
    ok = disc > 0.0
    k = c * mn + torch.sqrt(torch.clamp_min(disc, 1e-20))
    h = (k[:, None] * m - c[:, None] * normal) / a[:, None]
    hn = dot(h, normal)
    mh = dot(m, h)
    mi = dot(m, direction)
    ok = ok & (hn > 0.0) & (mh > 1e-6) & (k > 0.0) & (torch.abs(mi) > 1e-6)
    p = (hn * k * k) / (math.pi * a * a * torch.clamp_min(mh, 1e-6)
                        * 4.0 * torch.clamp_min(torch.abs(mi), 1e-6))
    return torch.where(ok, p, torch.zeros_like(p)).to(dtype)


def specular_env_density(scene: Scene, index: torch.Tensor,
                         direction: torch.Tensor, normal: torch.Tensor,
                         outer: torch.Tensor, omega_l: torch.Tensor,
                         cfg: RenderConfig, roughness_fresnel: bool = False,
                         reflect_kill: Optional[bool] = None
                         ) -> torch.Tensor:
    """``P(reflect lobe) * p_spec(omega_l)``: the joint density of the
    interaction choosing the reflect lobe and scattering into ``omega_l``,
    with the roulette's probability taken at the halfway vector of
    ``omega_l``. Without ``reflect_kill`` (default: ``roughness_fresnel``)
    a below-surface reflection folds onto its mirror, so the density gains
    the preimage at ``-omega_l``; with it that mass carries no energy and
    is left out. 0 below the faced normal."""
    if reflect_kill is None:
        reflect_kill = roughness_fresnel
    mat = scenelib.materials_at(scene, index)
    alpha = mat.roughness * mat.roughness

    def p_with_sel(w):
        m = _halfway(w, direction, normal)
        p_sel = _p_reflect(dot(m, direction), outer, mat.roughness,
                           mat.metallic, mat.ior, cfg, roughness_fresnel)
        return p_sel * _reflect_density_raw(direction, normal, alpha, w)

    p = p_with_sel(omega_l)
    if not reflect_kill:
        p = p + p_with_sel(-omega_l)
    return torch.where(dot(omega_l, normal) > 0.0, p, torch.zeros_like(p))


@traced("shade")
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
