"""sweep_ms: the window's length over the whole sweeps it completed, in ms
(a sweep is n coordinate picks or n / block block picks, each sweep with
its record)."""


def read(run):
    return 1e3 * run.window_s / run.sweeps()
