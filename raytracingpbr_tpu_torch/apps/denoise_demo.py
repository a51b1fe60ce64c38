"""Denoiser demo pipeline (port of ``raytracingpbr_tpu/apps/denoise_demo.py``):
the reference's prototype (``examples/denoise/denoise_test_1.py``): sample
an HDR texture with jitter, inject unbiased dropout noise, accumulate, and
run the hole-filling denoiser against a feedback buffer. Runs on the card
unless ``--device cpu``.

Usage:
    python -m raytracingpbr_tpu_torch.apps.denoise_demo --steps 100 \
        --out out/dn
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core import rng as rnglib
from ..core.device import resolve
from ..io import image as imageio
from ..models.demo import synthetic_hdr
from ..ops import post as postlib
from ..ops.ibl import _texture_nearest, hdr_environment


def run(steps: int = 100, keep: float = 0.5, threshold: float = 0.2,
        resolution=(768, 432), out_dir: str | None = None, device=None):
    """``steps`` jittered, dropped-out samples of the synthetic HDR map a
    pixel, denoised each step against the feedback buffer. Returns host
    arrays ``(noisy (H, W, 3), denoised (H, W, 3))``; with ``out_dir``
    also writes them as ``noisy.png`` and ``denoised.png``."""
    device = resolve(device)
    w, h = resolution
    n = w * h
    env = hdr_environment(synthetic_hdr(w // 4, h // 4), prebake=False,
                          device=device)
    pid = torch.arange(n, dtype=torch.int64, device=device)
    x = (pid // h).to(torch.float32)
    y = (pid % h).to(torch.float32)
    # divisors on the device: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, one rounding more than the CPU's
    # division, which now and then moves a sample across a texel edge
    w_t, h_t = (torch.tensor(float(v), device=device) for v in (w, h))
    ones = torch.ones((n, 1), device=device)
    accum = torch.zeros((n, 4), device=device)
    feedback = torch.zeros((h, w, 3), device=device)
    for k in range(steps):
        # jittered texture sample (denoise_test_1.py:61-66)
        jx = rnglib.uniform(pid, k, 0)
        jy = rnglib.uniform(pid, k, 1)
        uv = torch.stack([(x + jx) / w_t, (y + jy) / h_t], -1)
        sample = _texture_nearest(env.image, uv)
        # unbiased dropout noise (:75-83)
        sample = postlib.inject_dropout_noise(
            sample, rnglib.uniform(pid, k, 2), keep)
        accum = accum + torch.cat([sample, ones], -1)
        img = postlib.average(accum).reshape(w, h, 3).permute(1, 0, 2)
        feedback = postlib.denoise(torch.flip(img, dims=(0,)), feedback,
                                   threshold)
    noisy = torch.flip(postlib.average(accum).reshape(w, h, 3)
                       .permute(1, 0, 2), dims=(0,)).cpu().numpy()
    denoised = feedback.cpu().numpy()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        imageio.write_png(os.path.join(out_dir, "noisy.png"),
                          np.clip(noisy, 0, 1))
        imageio.write_png(os.path.join(out_dir, "denoised.png"),
                          np.clip(denoised, 0, 1))
    return noisy, denoised


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--resolution", default="768x432", help="WIDTHxHEIGHT")
    p.add_argument("--device", default=None, help="cpu, or the card "
                                                  "(default)")
    p.add_argument("--out", default="out/denoise")
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.resolution.lower().split("x"))
    run(steps=args.steps, resolution=(w, h), out_dir=args.out,
        device=args.device)


if __name__ == "__main__":
    main()
