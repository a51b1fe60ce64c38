"""Environment lighting (port of ``raytracingpbr_tpu/ops/ibl.py``):
the analytic skies. The HDR texture kind waits for the HDR slice."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from ..core.math import mix


class SkyKind(str, enum.Enum):
    HDR = "hdr"
    GRADIENT = "gradient"
    BLACK = "black"
    WHITE = "white"
    CONSTANT = "constant"


@dataclasses.dataclass
class Environment:
    kind: str
    bilinear: bool = False
    image: Optional[torch.Tensor] = None    # (W, H, 3), HDR only
    scale: torch.Tensor = None              # () post-lookup multiplier
    color_a: Optional[torch.Tensor] = None  # gradient horizon / constant
    color_b: Optional[torch.Tensor] = None  # gradient zenith


def _scalar(v, device, dtype):
    return torch.as_tensor(v, dtype=dtype, device=device)


def black_sky(device=None, dtype=torch.float32) -> Environment:
    return Environment(SkyKind.BLACK.value, scale=_scalar(1.0, device, dtype))


def white_sky(device=None, dtype=torch.float32) -> Environment:
    return Environment(SkyKind.WHITE.value, scale=_scalar(1.0, device, dtype))


def constant_sky(color, device=None, dtype=torch.float32) -> Environment:
    return Environment(SkyKind.CONSTANT.value,
                       scale=_scalar(1.0, device, dtype),
                       color_a=_scalar(color, device, dtype))


def gradient_sky(scale: float = 1.8, device=None,
                 dtype=torch.float32) -> Environment:
    """Procedural gradient sky (horizon -> zenith)."""
    return Environment(SkyKind.GRADIENT.value,
                       scale=_scalar(scale, device, dtype),
                       color_a=_scalar([1.0, 1.0, 0.5], device, dtype),
                       color_b=_scalar([0.25, 0.35, 1.0], device, dtype))


def sky_color(env: Environment, direction: torch.Tensor) -> torch.Tensor:
    """Environment radiance along ``direction`` (N, 3) -> (N, 3)."""
    kind = SkyKind(env.kind)
    if kind == SkyKind.BLACK:
        return torch.zeros_like(direction)
    if kind == SkyKind.WHITE:
        return torch.ones_like(direction) * env.scale
    if kind == SkyKind.CONSTANT:
        return torch.broadcast_to(env.color_a, direction.shape) * env.scale
    if kind == SkyKind.GRADIENT:
        t = 0.5 * direction[..., 1:2] + 0.5
        return mix(env.color_a, env.color_b, t) * env.scale
    raise NotImplementedError("HDR environments are not ported yet")
