"""The black sky: no image, no radiance."""
import torch


def image(sky):
    return None


def bake(sky, image, device, dtype):
    return {"kind": "black"}


def color(baked, direction):
    return torch.zeros_like(direction)
