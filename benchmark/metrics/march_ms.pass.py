"""Per-layer metric ``march_ms.pass`` (ms): the device time of the march
kernels (K1a-K1d, by name) a sample pass of an offline cell. Returns None
where the traced run has nothing to read."""


def read(tr):
    ks = tr.march_kernels()
    if tr.kind != "offline" or not ks or not tr.units:
        return None
    return sum(d for _, _, d in ks) / 1e3 / tr.units
