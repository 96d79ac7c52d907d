"""Shape buckets for the serving layer (port of ``repro/serve/bucketing.py``).

A batch's RHS block is padded up to one of a few widths, so the executor
cache holds one chunk executor per bucket, not per observed width, and the
padding is stripped again on exit.

Zero-padding the RHS axis is exact for both engine actions: columns are
independent (every update's ``gamma`` is computed per column), and a zero
column solves ``A x = 0`` from ``x0 = 0``, so every update is exactly zero
and padded columns stay zero.  Every kernel of a chunk (the sweep, the
matvec and ``colsum``) gives a column the same bits whatever the column
count, so a request's columns take bitwise the trajectory they would take
unpadded.
"""
from __future__ import annotations

import torch

#: RHS-width buckets: powers of two up to the default max batch.  Widths
#: beyond the top bucket round up to a multiple of it.
RHS_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_rhs(k: int, buckets=RHS_BUCKETS) -> int:
    """Smallest bucket >= ``k`` (beyond the top: next multiple of it)."""
    if k <= 0:
        raise ValueError(f"k must be > 0 (got {k})")
    for cap in buckets:
        if k <= cap:
            return cap
    top = buckets[-1]
    return -(-k // top) * top


def pad_columns(b: torch.Tensor, k_bucket: int) -> torch.Tensor:
    """Zero-pad ``b``'s RHS axis ``(n, k) -> (n, k_bucket)`` on b's
    device."""
    n, k = b.shape
    if k > k_bucket:
        raise ValueError(f"cannot pad {k} columns into a {k_bucket} bucket")
    if k == k_bucket:
        return b
    return torch.cat([b, b.new_zeros((n, k_bucket - k))], dim=1)


def unpad_columns(x: torch.Tensor, k: int) -> torch.Tensor:
    """Strip bucket padding: the first ``k`` columns are the real ones."""
    return x[:, :k]
