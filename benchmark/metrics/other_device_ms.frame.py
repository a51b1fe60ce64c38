"""Per-layer metric ``other_device_ms.frame`` (ms): the device time a displayed
frame of every kernel that is not a march kernel (shading, sky, tonemap,
RNG, the wavefront's bookkeeping). Returns None where the traced run has
nothing to read."""


def read(tr):
    if tr.kind != "frames" or not tr.units or not tr.kernels:
        return None
    every = sum(d for _, _, d in tr.kernels)
    march = sum(d for _, _, d in tr.march_kernels())
    return (every - march) / 1e3 / tr.units
