"""solve_p95_ms: the 95th percentile (nearest rank) of every solve's time
from when it was due to when its result was on the host, in ms."""
from bench.harness import p95


def read(run):
    return 1e3 * p95([u.done - u.due for u in run.units])
