"""rhs_per_s: right-hand-side columns solved to their tolerance, over the
whole window, per second of the window."""


def read(run):
    return sum(u.converged for u in run.units) / run.window_s
