"""ROLLBACK_HALF_UP over-relaxation: a lane whose bounding spheres of this
trip and the last fail to overlap (``d + dist < s``, with a relative
epsilon so that exactly touching bounds roll back too) steps back by the
part of its last step beyond the plain sphere trace, and its omega moves
half way to 1 (``0.5 + 0.5 w``)."""
import torch


def trip(t, w, s, d, dist, done, rc):
    rollback = d + dist < s * (1.0 + 1e-6)
    return rollback, torch.where(rollback, 0.5 + 0.5 * w, w)
