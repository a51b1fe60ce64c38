"""Environment lighting (port of ``raytracingpbr_tpu/ops/ibl.py``): the
analytic skies and the equirectangular HDR map, fetched nearest or
bilinear with plain gathers (the JAX package's one-hot matmul fetch is a
TPU workaround and is not carried over). NEE environment sampling is not
ported yet."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from ..core.device import resolve
from ..core.math import mix, sample_spherical_map


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
    return torch.as_tensor(v, dtype=dtype, device=resolve(device))


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


def adjust(rgb, exposure, gamma):
    """Exposure multiply and power curve (the HDR pipeline passes gamma =
    2.2 to pre-bake the decode into the texture)."""
    return (rgb * exposure) ** gamma


def hdr_environment(image, exposure: float = 1.4, gamma: float = 2.2,
                    bilinear: bool = False, prebake: bool = True,
                    scale: float = 1.0, device=None,
                    dtype=torch.float32) -> Environment:
    """HDR equirect environment from a (W, H, 3) linear image indexed
    ``img[x, y]``; ``prebake`` applies the exposure/gamma adjust once
    here. An image handed as a tensor stays on its device unless
    ``device`` says otherwise."""
    if not (device is None and isinstance(image, torch.Tensor)):
        device = resolve(device)
    img = torch.as_tensor(image, dtype=dtype, device=device)
    if prebake:
        img = adjust(img, exposure, gamma)
    return Environment(SkyKind.HDR.value, bilinear=bilinear, image=img,
                       scale=_scalar(scale, img.device, dtype))


def _texture_nearest(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest texel, by truncation of ``uv * (W, H)``."""
    w, h = img.shape[0], img.shape[1]
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return img[x, y]


def _texture_bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch, wrapping in x and clamping in y."""
    w, h = img.shape[0], img.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    c00 = img[x0w, y0c]
    c10 = img[x1w, y0c]
    c01 = img[x0w, y1c]
    c11 = img[x1w, y1c]
    return mix(mix(c00, c10, tx), mix(c01, c11, tx), ty)


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
    if env.image is None:
        raise ValueError("an HDR environment needs its (W, H, 3) image")
    uv = sample_spherical_map(direction)
    tex = _texture_bilinear if env.bilinear else _texture_nearest
    return tex(env.image, uv) * env.scale
