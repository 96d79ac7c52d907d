"""roofline.sweep_rows_gs: the frozen bound of the traced coordinate GS
sweeps (``roofline_frozen.sweep_rows_gs``, counted from each launch's
picks) over the device time of ``gs_kernel`` (``csrc/sweep_csr.cu``), in %
(layer: kernels)."""
from bench import roofline_frozen as rf

KERNEL = r"(^|[^\w])gs_kernel<"


def read(run):
    t = run.trace
    spent = 0.0 if t is None else t.seconds(KERNEL)
    if spent <= 0 or run.driver.block != 1:
        return None
    bound = 0.0
    for s in run.record_stats():
        b = rf.bound_s(rf.sweep_rows_gs(
            distinct_nnz=s["distinct_nnz"], distinct_rows=s["distinct"],
            picks=s["picks"], stream_nnz=s["stream_nnz"], n=run.n,
            k=run.driver.k), run.device_name)
        if b is None:
            return None
        bound += b
    return 100.0 * bound / spent
