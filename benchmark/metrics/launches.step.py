"""Per-layer metric ``launches.step``, and ``launches.step.<qualifier>``, the
same reading under the bound of its cells' regime, (launches): the CUDA
kernels launched a fwd+bwd step, from the profiler's device events over the
traced sub-window of a grad cell. Returns None where the traced run has
nothing to read."""


def read(tr):
    if tr.kind != "grad" or not tr.units or not tr.kernels:
        return None
    return len(tr.kernels) / tr.units
