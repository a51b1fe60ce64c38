"""Image comparison metrics (numpy), for golden gating and parity: PSNR,
SSIM and the correlation of block means. They run on the host over small
images."""
from __future__ import annotations

import numpy as np


def _as_float(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a.astype(np.float64) / 255.0
    return a.astype(np.float64)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over all channels (inf if equal)."""
    a, b = _as_float(a), _as_float(b)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


def _filter2(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' filter over the leading two axes."""
    out = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 0, img)
    return np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, out)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004): an 11 x 11 gaussian window (sigma
    1.5), K1 0.01, K2 0.03; the per-channel maps' means averaged. An image
    smaller than the window takes a window of its smaller side."""
    a, b = _as_float(a), _as_float(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    size = 11 if min(a.shape[0], a.shape[1]) >= 11 else min(a.shape[:2])
    k = _gaussian_kernel(size)
    vals = []
    for ch in range(a.shape[2]):
        x, y = a[..., ch], b[..., ch]
        mx, my = _filter2(x, k), _filter2(y, k)
        mxx, myy, mxy = (_filter2(x * x, k), _filter2(y * y, k),
                         _filter2(x * y, k))
        vx, vy = mxx - mx * mx, myy - my * my
        cov = mxy - mx * my
        num = (2 * mx * my + c1) * (2 * cov + c2)
        den = (mx * mx + my * my + c1) * (vx + vy + c2)
        vals.append(float(np.mean(num / den)))
    return float(np.mean(vals))


def block_corr(a: np.ndarray, b: np.ndarray, k: int = 16) -> float:
    """Correlation of the images' means over a k x k grid of blocks (the
    trailing rows and columns that do not fill a block left out): a
    coarse structural agreement, robust to Monte-Carlo noise."""
    a, b = _as_float(a), _as_float(b)

    def blocks(img):
        h, w = img.shape[:2]
        return img[: h // k * k, : w // k * k].reshape(
            k, h // k, k, w // k, -1).mean((1, 3))

    return float(np.corrcoef(blocks(a).ravel(), blocks(b).ravel())[0, 1])
