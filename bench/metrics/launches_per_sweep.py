"""launches_per_sweep: the program's own launch counters
(``repro_torch.kernels.ops.launch_counts``) over the window, per sweep
(layer: dispatch seam)."""


def read(run):
    return sum(run.launches.values()) / run.sweeps()
