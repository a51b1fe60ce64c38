"""The sphere of radius ``scale[0]``."""
from .. import scene as sc

ID = 1
WEIGHTS = False


def sd(scene, lo, hi, p, chains):
    return sc.safe_norm(p) - scene.scale[lo:hi][..., 0]
