"""Per-layer metric ``launches.pass`` (launches): the CUDA kernels launched a
sample pass of an offline cell, from the profiler's device events over the
traced sub-window. Returns None where the traced run has nothing to read."""


def read(tr):
    if tr.kind != "offline" or not tr.units or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units
