"""Environment lighting (port of ``raytracingpbr_tpu/ops/ibl.py``): the
analytic skies and the equirectangular HDR map, fetched nearest or
bilinear with plain gathers (the JAX package's one-hot matmul fetch is a
TPU workaround and is not carried over), and the importance samplers that
next-event estimation draws from: the alias table baked into the
environment (``with_env_sampler``, ``sample_env_baked``, ``env_pdf``) and
the luminance-CDF sampler (``build_env_sampler``, ``sample_env``)."""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve
from ..core.math import brightness, mix, sample_spherical_map
from ..utils.profiling import traced


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
    # the NEE alias table (with_env_sampler); None: no table baked
    s_prob: Optional[torch.Tensor] = None   # (W*H,) acceptance probability
    s_alias: Optional[torch.Tensor] = None  # (W*H,) i32 alias texel
    s_pdf: Optional[torch.Tensor] = None    # (W, H) solid-angle pdf

    def replace(self, **kw) -> "Environment":
        return dataclasses.replace(self, **kw)


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


@traced("sky")
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


# ---------------------------------------------------------------------------
# Importance sampling of an HDR map (next-event estimation)
# ---------------------------------------------------------------------------

_BLOCK = 32


def _row_major_sums(blocks: np.ndarray) -> np.ndarray:
    """Each row of the last axis summed in f32, one element after another."""
    acc = np.zeros(blocks.shape[:-1], np.float32)
    for k in range(blocks.shape[-1]):
        acc = (acc + blocks[..., k]).astype(np.float32)
    return acc


def _sum_in_order(a: np.ndarray) -> np.float32:
    """The f32 sum of ``a`` in the reference's order: an array with an axis
    longer than 32 is cut into blocks of 32 along each axis (padded with
    zeros, half before and half after) whose sums, each taken in row-major
    order, are summed the same way; a smaller array is summed in row-major
    order. The alias table's pdf divides by this sum, so the table is
    bit-equal to the reference's."""
    a = np.asarray(a, np.float32)
    if all(d <= _BLOCK for d in a.shape):
        return _row_major_sums(a.reshape(1, -1))[0]
    wins = [min(_BLOCK, d) for d in a.shape]
    pads = [-(-d // w) * w - d for d, w in zip(a.shape, wins)]
    a = np.pad(a, [(p // 2, p - p // 2) for p in pads])
    counts = [d // w for d, w in zip(a.shape, wins)]
    split = [v for c, w in zip(counts, wins) for v in (c, w)]
    order = list(range(0, 2 * a.ndim, 2)) + list(range(1, 2 * a.ndim, 2))
    blocks = a.reshape(split).transpose(order).reshape(
        counts + [int(np.prod(wins))])
    return _sum_in_order(_row_major_sums(blocks))


def _texel_weights(env: Environment):
    """Per texel of the (W, H) map, on the host in f32: the luminance times
    cos(latitude) (at least 1e-12) and the solid-angle pdf of drawing the
    texel in proportion to it. cos is taken in float64 and rounded, which
    is the correctly rounded f32 value."""
    img = env.image.detach().cpu()
    w, h = img.shape[0], img.shape[1]
    y = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    lat = (y - 0.5) * math.pi
    sin_theta = torch.cos(lat.to(torch.float64)).to(torch.float32)
    lum = torch.clamp_min(brightness(img) * sin_theta[None, :], 1e-12)
    texel_sa = (2 * math.pi / w) * (math.pi / h) * sin_theta[None, :]
    total = torch.tensor(_sum_in_order(lum.numpy()))
    pdf = lum / total / torch.clamp_min(texel_sa, 1e-12)
    return lum, pdf, sin_theta


@dataclasses.dataclass
class EnvImportanceSampler:
    """Luminance-CDF sampler over an equirect map: a marginal CDF over the
    columns (longitude) and a conditional CDF over each column's texels."""

    env: Environment
    row_cdf: torch.Tensor   # (W,)
    cond_cdf: torch.Tensor  # (W, H)
    pdf_map: torch.Tensor   # (W, H) solid-angle pdf of each texel


def build_env_sampler(env: Environment) -> EnvImportanceSampler:
    """The CDF sampler of an HDR environment (tables on the image's
    device)."""
    lum, pdf, _ = _texel_weights(env)
    col_mass = lum.sum(dim=1)
    row_cdf = torch.cumsum(col_mass, 0) / col_mass.sum()
    cond = torch.cumsum(lum, dim=1)
    cond_cdf = cond / cond[:, -1:]
    dev = env.image.device
    return EnvImportanceSampler(env, row_cdf.to(dev), cond_cdf.to(dev),
                                pdf.to(dev))


@dataclasses.dataclass
class EnvAliasSampler:
    """Alias-method (Walker/Vose) sampler over an equirect map: the same
    distribution as :class:`EnvImportanceSampler`, two gathers a draw."""

    env: Environment
    prob: torch.Tensor     # (W*H,) acceptance probability per texel
    alias: torch.Tensor    # (W*H,) i32 alias texel
    pdf_map: torch.Tensor  # (W, H) solid-angle pdf of each texel


def _vose(lum: np.ndarray):
    """Vose's alias construction in float64 on the host."""
    p = np.asarray(lum, np.float64).reshape(-1)
    n = p.size
    p = p / p.sum() * n
    alias = np.zeros(n, np.int32)
    prob = np.ones(n, np.float64)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, big = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = big
        p[big] = p[big] - (1.0 - p[s])
        (small if p[big] < 1.0 else large).append(big)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias


def build_env_alias_sampler(env: Environment) -> EnvAliasSampler:
    """The alias table of an HDR environment (tables on the image's
    device)."""
    lum, pdf, _ = _texel_weights(env)
    prob, alias = _vose(lum.numpy())
    dev = env.image.device
    return EnvAliasSampler(env, torch.from_numpy(prob).to(dev),
                           torch.from_numpy(alias).to(dev), pdf.to(dev))


def with_env_sampler(env: Environment) -> Environment:
    """The environment with its alias table baked in (what
    ``cfg.env_sampling`` draws from). HDR maps only: raises ValueError for
    any other sky."""
    if SkyKind(env.kind) != SkyKind.HDR:
        raise ValueError("env_sampling requires an HDR environment; got "
                         f"{env.kind}")
    s = build_env_alias_sampler(env)
    return env.replace(s_prob=s.prob, s_alias=s.alias,
                       s_pdf=s.pdf_map.to(env.image.dtype))


def _direction(x, y, w, h, off_u, off_v, dtype):
    """The direction through texel (x, y) at offset (off_u, off_v) in it,
    and cos(latitude) there."""
    uu = (x.to(dtype) + off_u) / w
    vv = (y.to(dtype) + off_v) / h
    phi = (uu - 0.5) * (2 * math.pi)
    lat = (vv - 0.5) * math.pi
    cl = torch.cos(lat)
    d = torch.stack([cl * torch.cos(phi), torch.sin(lat),
                     cl * torch.sin(phi)], dim=-1)
    return d, cl


def _cell(u: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp((u * n).to(torch.int64), 0, n - 1)


def sample_env_alias(sampler: EnvAliasSampler, u1: torch.Tensor,
                     u2: torch.Tensor):
    """Directions drawn through the alias table: ``u1`` picks the cell,
    ``u2`` the accept/alias branch. Returns (direction (N, 3), radiance
    (N, 3), pdf (N,)) at the texel centres."""
    img = sampler.env.image
    w, h = img.shape[0], img.shape[1]
    cell = _cell(u1, w * h)
    take_alias = u2 >= sampler.prob[cell]
    texel = torch.where(take_alias, sampler.alias[cell].to(torch.int64),
                        cell)
    x, y = texel // h, texel % h
    d, _ = _direction(x, y, w, h, 0.5, 0.5, img.dtype)
    return d, img[x, y] * sampler.env.scale, sampler.pdf_map[x, y]


def _texel_center_cl(y: torch.Tensor, h: int, dtype) -> torch.Tensor:
    """cos(latitude) at the centre of texel row ``y``: the weight baked into
    ``s_pdf``."""
    vv = (y.to(dtype) + 0.5) / h
    return torch.cos((vv - 0.5) * math.pi)


def sample_env_baked(env: Environment, u: torch.Tensor,
                     u_accept: Optional[torch.Tensor] = None,
                     u_jitter: Optional[tuple] = None):
    """Directions drawn from the table baked by :func:`with_env_sampler`:
    ``u`` picks the cell, ``u_accept`` the accept/alias branch (default:
    ``u``'s fraction, which quantizes the test on large maps; pass a second
    uniform). ``u_jitter=(ux, uy)`` places the draw uniformly inside the
    texel, with the exact pdf ``s_pdf * cos(lat_centre) / cos(lat)``;
    without it the draw is the texel centre. Returns (direction (N, 3),
    radiance (N, 3), pdf (N,))."""
    img = env.image
    w, h = img.shape[0], img.shape[1]
    n = w * h
    scaled = u * n
    cell = _cell(u, n)
    if u_accept is None:
        u_accept = scaled - cell.to(scaled.dtype)
    take_alias = u_accept >= env.s_prob[cell]
    texel = torch.where(take_alias, env.s_alias[cell].to(torch.int64), cell)
    x, y = texel // h, texel % h
    off_u, off_v = (0.5, 0.5) if u_jitter is None else u_jitter
    d, cl = _direction(x, y, w, h, off_u, off_v, img.dtype)
    radiance = img[x, y] * env.scale
    pdf = env.s_pdf[x, y]
    if u_jitter is not None:
        pdf = pdf * _texel_center_cl(y, h, img.dtype) \
            / torch.clamp_min(cl, 1e-4)
    return d, radiance, pdf


def env_pdf(env: Environment, direction: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of the baked, jittered sampler at ``direction``
    (the MIS weights need the competing sampler's density):
    ``s_pdf[texel] * cos(lat_centre) / cos(lat)``. Needs a baked table."""
    img = env.image
    w, h = img.shape[0], img.shape[1]
    uv = sample_spherical_map(direction)
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    cl = torch.sqrt(torch.clamp_min(1.0 - direction[..., 1] ** 2, 1e-8))
    return env.s_pdf[x, y] * _texel_center_cl(y, h, img.dtype) \
        / torch.clamp_min(cl, 1e-4)


def sample_env(sampler: EnvImportanceSampler, u1: torch.Tensor,
               u2: torch.Tensor):
    """Directions drawn through the CDFs (two binary searches). Returns
    (direction, radiance, pdf) at the texel centres."""
    img = sampler.env.image
    w, h = img.shape[0], img.shape[1]
    x = torch.clamp(torch.searchsorted(sampler.row_cdf, u1), 0, w - 1)
    cdf_x = sampler.cond_cdf[x]
    y = torch.clamp(torch.searchsorted(cdf_x, u2[:, None]).squeeze(-1), 0,
                    h - 1)
    d, _ = _direction(x, y, w, h, 0.5, 0.5, img.dtype)
    return d, img[x, y] * sampler.env.scale, sampler.pdf_map[x, y]
