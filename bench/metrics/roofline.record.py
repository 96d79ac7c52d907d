"""roofline.record: the frozen bound of the traced records' matvec and
column sums (``roofline_frozen.spmv_csr`` + ``colsum``, a record each) over
the device time of the CSR matvec kernels (``rw_kernel``,
``segsum_kernel``: ``csrc/spmv_csr.cu``, ``csrc/common.cuh``) and of
``colsum_slices``/``colsum_finish`` (``csrc/colsum.cu``), in % (layer:
kernels)."""
from bench import roofline_frozen as rf

KERNELS = r"(^|[^\w])(rw_kernel|segsum_kernel|colsum_slices|colsum_finish)\b"


def read(run):
    t = run.trace
    spent = 0.0 if t is None else t.seconds(KERNELS)
    records = sum(u.records for u in run.units if u.traced)
    if spent <= 0 or records == 0:
        return None
    n, k = run.n, run.driver.k
    work = rf.spmv_csr(nnz=run.nnz, m=n, n=n, k=k) + rf.colsum(n=n, k=k)
    b = rf.bound_s(work, run.device_name)
    return None if b is None else 100.0 * records * b / spent
