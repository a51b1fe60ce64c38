"""RELATIVE: the distance under the pixel radius times ``t``."""
import torch


def hit(dist, t, rc):
    return dist / torch.clamp_min(t, 1e-12) < rc["pixel_radius"]
