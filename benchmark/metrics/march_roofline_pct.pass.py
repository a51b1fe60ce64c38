"""Per-layer metric ``march_roofline_pct.pass`` (%): the sum over the sub-
window's march calls of the least time an H100 could take for their work
(``metrics/work.march_bound``, from the trips each lane needed), over the
sum of the march kernels' device time, in an offline cell. Returns None
where the traced run has nothing to read."""


def read(tr):
    ks = tr.march_kernels()
    if tr.kind != "offline" or not ks or not tr.bounds:
        return None
    return 100.0 * sum(b["bound_ms"] for b in tr.bounds) / (
        sum(d for _, _, d in ks) / 1e3)
