"""device_idle: the share of the traced window in which no operation ran
on the card, in %, from the profiler's trace (layer: device)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
