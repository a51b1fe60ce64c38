"""The capped cylinder of radius ``scale[0]`` and half-height ``scale[1]``,
its axis along y."""
import torch

from .. import scene as sc

ID = 3
WEIGHTS = False


def sd(scene, lo, hi, p, chains):
    dxz = sc.safe_norm(p[..., ::2])
    d = torch.abs(torch.stack([dxz, p[..., 1]], -1)) \
        - scene.scale[lo:hi][..., :2]
    inner = torch.amax(d, dim=-1)
    return (torch.minimum(inner, torch.zeros_like(inner))
            + sc.safe_norm(torch.maximum(d, torch.zeros_like(d))))
