"""sweeps_per_solve: the mean sweeps a solve of the window ran before its
early exit or its cap (layer: engine)."""


def read(run):
    return run.sweeps() / len(run.units)
