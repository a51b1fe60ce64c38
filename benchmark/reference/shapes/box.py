"""The box of half-extents ``scale``, its edges rounded by the scene's
``box_round``."""
import torch

from .. import scene as sc

ID = 2
WEIGHTS = False


def sd(scene, lo, hi, p, chains):
    q = torch.abs(p) - scene.scale[lo:hi]
    outside = sc.safe_norm(torch.maximum(q, torch.zeros_like(q)))
    inner = torch.amax(q, dim=-1)
    inside = torch.minimum(inner, torch.zeros_like(inner))
    return outside + inside - scene.box_round
