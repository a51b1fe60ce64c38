"""The forward megakernel: the offline render's bounce loop, the plain
version of the program's ``megakernel_trace`` with ``differentiable``
False, as ``render_image`` runs it.

The base stage (``render.megakernel_trace``) is scan-AD's: it records a
graph and folds a below-surface reflection back above the surface. The
program's forward pass kills such a reflection instead (``reflect_kill``,
on where the roughness-remapped Fresnel is and no gradient is taken), and
records nothing. This stage is the base with the kill on, under
``torch.no_grad()``, and it also counts each lane's bounces as the
program's ``TraceResult.bounces`` does: the bounces at which the lane was
alive and hit a surface.

No configuration lists it: the ``offline`` traffic kind adds it to the
render settings of its check (``kinds/offline.py``)."""
from __future__ import annotations

import torch

from .. import scene as sc
from .. import stage
from ..march import march_full
from ..render import (MASK, S_ROULETTE, S_SHADE, _where, brightness,
                      sky_color, uniform4)


def megakernel_trace(scene, sky, rays, pixel_id, sample_idx: int, rc: dict,
                     chains: bool = True, with_bounces: bool = False):
    """The forward bounce loop of a batch of paths (EXP roulette where
    configured; the full march gated by ``alive``; the interaction with
    the roughness-remapped Fresnel, restarting at the hit, a below-surface
    reflection killed; the sky on a miss), until no lane is alive or
    ``max_raytrace`` bounces have run. Returns the (N, 3) radiance, or
    with ``with_bounces`` (radiance, (N,) int32 bounce counts)."""
    origin, direction, color, _ = rays
    dtype = color.dtype
    max_bounce = rc["max_raytrace"]
    base = (int(sample_idx) & MASK) * max_bounce
    alive = torch.ones(origin.shape[:1], dtype=torch.bool,
                       device=origin.device)
    bounces = torch.zeros(origin.shape[:1], dtype=torch.int32,
                          device=origin.device)
    vis = rc["visibility"]
    with torch.no_grad():
        i = 0
        while i < max_bounce:
            counter = (base + i) & MASK
            if rc["roulette"] == "exp":
                inv_pdf = torch.exp(torch.tensor(i, dtype=torch.float32)
                                    / rc["light_quality"])
                roulette_prob = float(1.0 - 1.0 / inv_pdf)
                u = uniform4(pixel_id, counter, S_ROULETTE, rc["seed"],
                             dtype)[0]
                die = u < roulette_prob
                color = torch.where((alive & die)[:, None],
                                    color * roulette_prob, color)
                alive = alive & ~die
            t, position, index, hit = march_full(
                scene, origin, direction, rc, active=alive, chains=chains)
            u4 = uniform4(pixel_id, counter, S_SHADE, rc["seed"], dtype)
            emission = sc.materials_at(scene, index)[1]
            new_dir, new_origin, color_scale, _ = stage(rc, "interaction")(
                scene, index, position, direction, u4, rc,
                roughness_fresnel=True, restart_at_hit=True,
                reflect_kill=True)
            color_hit = color * color_scale
            intensity = brightness(color_hit)
            color_hit = color_hit * emission
            visible = brightness(color_hit)
            stop_hit = ((intensity < visible) | (visible < vis[0])
                        | (visible > vis[1]))
            color_miss = color * sky_color(sky, direction)
            on = alive & hit
            color = _where(on, color_hit, _where(alive & ~hit, color_miss,
                                                 color))
            origin = _where(on, new_origin, origin)
            direction = _where(on, new_dir, direction)
            bounces = bounces + on.to(torch.int32)
            alive = on & ~stop_hit
            i += 1
            if not bool(alive.any()):
                break
    return (color, bounces) if with_bounces else color
