"""ABSOLUTE: the distance under ``hit_precision``."""


def hit(dist, t, rc):
    return dist < rc["hit_precision"]
