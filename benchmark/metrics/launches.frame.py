"""Per-layer metric ``launches.frame`` (launches): the CUDA kernels launched a
displayed frame, from the profiler's device events over the traced sub-
window of a frames cell. Returns None where the traced run has nothing to
read."""


def read(tr):
    if tr.kind != "frames" or not tr.units or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units
