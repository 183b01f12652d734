"""device.idle_pct: the share of the traced window in which no kernel,
memcpy or memset ran on the card, in percent."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
