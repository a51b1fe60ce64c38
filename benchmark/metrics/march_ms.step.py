"""Per-layer metric ``march_ms.step``, and ``march_ms.step.<qualifier>``, the
same reading under the bound of its cells' regime, (ms): the device time of
the march kernels (K1a-K1d, by name) a fwd+bwd step. Returns None where the
traced run has nothing to read."""


def read(tr):
    ks = tr.march_kernels()
    if tr.kind != "grad" or not ks or not tr.units:
        return None
    return sum(d for _, _, d in ks) / 1e3 / tr.units
