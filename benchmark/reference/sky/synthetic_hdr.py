"""The seeded stand-in HDR map (a sky gradient, a sun disk and a colour
ripple), baked by exposure and gamma and read by its spherical map,
bilinear or nearest."""
import math

import numpy as np
import torch


def image(sky):
    """The (W, H, 3) map of ``sky``'s ``width``, ``height`` and ``seed``."""
    width, height = sky["width"], sky["height"]
    rng = np.random.default_rng(sky["seed"])
    x = (np.arange(width) + 0.5) / width
    y = (np.arange(height) + 0.5) / height
    xx, yy = np.meshgrid(x, y, indexing="ij")
    base = (np.stack([1.0 - 0.5 * yy, 0.8 * np.ones_like(yy),
                      0.5 + 0.5 * yy], axis=-1))
    sun_x, sun_y = 0.3, 0.75
    d2 = (xx - sun_x) ** 2 + (yy - sun_y) ** 2
    sun = np.exp(-d2 / 0.002)[..., None] * np.array([50.0, 45.0, 35.0])
    ripple = 0.15 * np.sin(2 * np.pi * (3 * xx + 2 * yy))[..., None] \
        * rng.uniform(0.5, 1.0, size=(1, 1, 3))
    return (base + sun + ripple).astype(np.float32)


def bake(sky, image, device, dtype):
    img = torch.as_tensor(image, dtype=dtype, device=device)
    img = (img * sky["exposure"]) ** sky["gamma"]
    return {"kind": sky["kind"], "image": img, "bilinear": sky["bilinear"],
            "scale": torch.as_tensor(1.0, dtype=dtype, device=device)}


def _spherical_uv(v):
    u = torch.atan2(v[..., 2], v[..., 0]) * (0.5 / math.pi) + 0.5
    w = torch.asin(torch.clamp(v[..., 1], -1.0, 1.0)) * (1.0 / math.pi) + 0.5
    return torch.stack([u, w], dim=-1)


def _nearest_texel(img, uv):
    w, h = img.shape[0], img.shape[1]
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return img[x, y]


def _mix(a, b, t):
    return a + (b - a) * t


def _bilinear(img, uv):
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
    c00, c10 = img[x0w, y0c], img[x1w, y0c]
    c01, c11 = img[x0w, y1c], img[x1w, y1c]
    return _mix(_mix(c00, c10, tx), _mix(c01, c11, tx), ty)


def color(baked, direction):
    uv = _spherical_uv(direction)
    tex = _bilinear if baked["bilinear"] else _nearest_texel
    return tex(baked["image"], uv) * baked["scale"]
