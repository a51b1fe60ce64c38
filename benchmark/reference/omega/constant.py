"""CONSTANT over-relaxation: the carried omega, never a rollback."""
import torch


def trip(t, w, s, d, dist, done, rc):
    return torch.zeros_like(done), w
