"""Postprocess (port of ``raytracingpbr_tpu/ops/post.py``): accumulation
mean, exposure / gamma, fitted ACES, the adaptive-sampling noise metric,
and the hole-filling denoiser with its dropout-noise injector."""
from __future__ import annotations

import torch

from ..config import RenderConfig, Tonemap
from ..core.math import brightness
from ..utils.profiling import traced

# Stephen Hill's fitted ACES matrices, applied as M @ rgb.
ACES_INPUT = ((0.59719, 0.35458, 0.04823),
              (0.07600, 0.90834, 0.01566),
              (0.02840, 0.13383, 0.83777))
ACES_OUTPUT = ((1.60475, -0.53108, -0.07367),
               (-0.10208, 1.10813, -0.00605),
               (-0.00327, -0.07276, 1.07602))


def rrt_and_odt_fit(v: torch.Tensor) -> torch.Tensor:
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def _mat3_apply(m, rgb: torch.Tensor) -> torch.Tensor:
    """``rgb @ m.T`` as nine scalar multiply-adds on the channels."""
    c = [rgb[..., k] for k in range(3)]
    rows = [m[i][0] * c[0] + m[i][1] * c[1] + m[i][2] * c[2] for i in range(3)]
    return torch.stack(rows, dim=-1)


def aces_fitted(rgb: torch.Tensor) -> torch.Tensor:
    """Fitted ACES RRT+ODT on (..., 3)."""
    return _mat3_apply(ACES_OUTPUT, rrt_and_odt_fit(_mat3_apply(ACES_INPUT,
                                                                 rgb)))


def average(accum: torch.Tensor) -> torch.Tensor:
    """Progressive mean rgb / count; zero-sample pixels stay black."""
    count = accum[..., 3:4]
    mean = accum[..., :3] / torch.clamp_min(count, 1e-12)
    return torch.where(count > 0, mean, torch.zeros_like(mean))


def adjust(rgb: torch.Tensor, exposure, gamma) -> torch.Tensor:
    """Exposure multiply and power."""
    return (rgb * exposure) ** gamma


def tonemap(rgb: torch.Tensor, cfg: RenderConfig, exposure=1.0):
    """Tonemap in the configured order (GAMMA_THEN_ACES: exposure, 1/gamma,
    ACES; ACES_THEN_GAMMA: exposure, ACES, 1/gamma), then the clamp."""
    inv_gamma = 1.0 / cfg.gamma
    if cfg.tonemap == Tonemap.GAMMA_THEN_ACES:
        out = aces_fitted(adjust(rgb, exposure, inv_gamma))
    elif cfg.tonemap == Tonemap.ACES_THEN_GAMMA:
        out = torch.clamp_min(aces_fitted(rgb * exposure), 0.0) ** inv_gamma
    else:
        out = rgb * exposure
    if cfg.clamp_output:
        out = torch.clamp(out, 0.0, 1.0)
    return out


@traced("post")
def post_process(accum: torch.Tensor, cfg: RenderConfig, exposure=1.0,
                 last_pixels=None, diff_accum=None):
    """Tonemapped mean plus the adaptive-sampling noise estimate (running
    mean of per-frame luma changes). Returns ``(pixels, diff_accum,
    noise)``; the last two are ``(diff_accum, None)`` unless
    ``cfg.adaptive_sampling``."""
    pixels = tonemap(average(accum), cfg, exposure)
    if not cfg.adaptive_sampling or last_pixels is None:
        return pixels, diff_accum, None
    diff = torch.abs(pixels - last_pixels)
    diff_accum = diff_accum + torch.stack(
        [brightness(diff), torch.ones_like(diff[..., 0])], dim=-1)
    noise = diff_accum[..., 0] / diff_accum[..., 1]
    return pixels, diff_accum, noise


def denoise(pixels_in: torch.Tensor, pixels_out: torch.Tensor,
            threshold: float = 0.2, blend: float = 0.2) -> torch.Tensor:
    """The hole-filling denoiser prototype
    (``examples/denoise/denoise_test_1.py:86-118``): blend ``in + (out -
    in) * blend``, and replace each pixel darker than ``threshold`` by the
    mean of the neighbours of its 4-neighbourhood in ``pixels_out`` that
    are brighter than ``threshold`` (edges clamped), where it has any.
    ``pixels_in`` / ``pixels_out``: (H, W, 3) current frame and feedback
    buffer. The reference reads its ``j+1`` neighbour twice; this is the
    intended 4-neighbourhood, as in the JAX package."""
    col = pixels_in + (pixels_out - pixels_in) * blend
    h, w = pixels_in.shape[0], pixels_in.shape[1]
    dev = pixels_in.device

    def shift(img, di, dj):
        # clamp-to-edge neighbour fetch over the whole image
        ii = torch.clamp(torch.arange(h, device=dev) + di, 0, h - 1)
        jj = torch.clamp(torch.arange(w, device=dev) + dj, 0, w - 1)
        return img[ii][:, jj]

    acc = torch.zeros_like(pixels_in)
    cnt = torch.zeros(pixels_in.shape[:-1] + (1,), dtype=pixels_in.dtype,
                      device=dev)
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nb = shift(pixels_out, di, dj)
        good = (brightness(nb) > threshold)[..., None]
        acc = acc + torch.where(good, nb, torch.zeros_like(nb))
        cnt = cnt + good.to(cnt.dtype)
    filled = acc / torch.clamp_min(cnt, 1.0)
    dark = (brightness(pixels_in) < threshold)[..., None] & (cnt > 0)
    return torch.where(dark, filled, col)


def inject_dropout_noise(pixels: torch.Tensor, u: torch.Tensor,
                         keep: float = 0.5) -> torch.Tensor:
    """Unbiased multiplicative dropout that exercises the denoiser
    (``denoise_test_1.py:75-83``): a pixel becomes 0 where ``u >= keep``,
    else ``pixels / keep``."""
    mask = (u < keep).to(pixels.dtype)[..., None]
    return pixels * mask / keep
