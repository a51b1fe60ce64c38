"""Per-layer metric ``device_idle_pct.pass`` (%): the share of an offline
cell's traced sub-window in which no kernel, copy or set ran on the card.
Returns None where the traced run has nothing to read."""


def read(tr):
    if tr.kind != "offline" or tr.window_us <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
