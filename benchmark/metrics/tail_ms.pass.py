"""Per-layer metric ``tail_ms.pass`` (ms): the device-clock time a sample
pass of an offline cell spends in its tail, the bounces that serve almost
no lanes. A march call is in the tail where the lane-trips its inputs need
(``bounds[b]["needed"]``) are under 1% of the most any call of the sub-
window needs; its share is the time from its march kernel's start to the
next march kernel's start (the sub-window's end after the last), which
holds the bounce's march, its shading and bookkeeping, its exit check's
sync and the host's dispatch of the next. The sub-window's march kernels
and recorded calls are paired in order. Returns None where the traced run
has nothing to read, or where the two counts differ."""


def read(tr):
    ks = sorted(tr.march_kernels(), key=lambda k: k[1])
    if (tr.kind != "offline" or not ks or not tr.units
            or len(ks) != len(tr.bounds)):
        return None
    top = max(b["needed"] for b in tr.bounds)
    ends = [k[1] for k in ks[1:]] + [tr.window[1]]
    tail = sum(end - k[1] for k, end, b in zip(ks, ends, tr.bounds)
               if b["needed"] < 0.01 * top)
    return tail / 1e3 / tr.units
