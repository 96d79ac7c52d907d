"""CUDA launcher of the column sums of the records (``csrc/colsum.cu``).

A kernel of the port's own (no TPU counterpart): ``record_metrics`` and
the distributed engine's metrics sum each RHS column with it, in an order
fixed by the row count alone, so a column's record does not depend on how
many columns ride along.  The design is in the source's header note.

``colsum`` takes a tensor already checked by ``kernels/ops.py`` (CUDA,
contiguous, 2-D f32) and launches on PyTorch's current stream.  It adds
one to ``LAUNCHES`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"colsum": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _P]
# The C entry of csrc/colsum.cu this launcher loads, with its argument
# types.
C_ENTRIES = {"colsum_f32": _ARGS}

# Rows of one run of the first kernel (one CTA a run and 32 columns).
ROWS_PER_SLICE = 256


def slices(n: int) -> int:
    """Row runs of an n-row sum: a function of n alone, so the order of a
    column's adds does not depend on k."""
    return max(1, -(-n // ROWS_PER_SLICE))


def colsum(t):
    """``t.sum(0)`` of an (n, k) f32 tensor on the card, (k,) f32."""
    n, k = t.shape
    s = slices(n)
    # One allocation: row 0 the sums, rows 1.. the runs' partial sums.
    buf = torch.empty((s + 1, k), dtype=torch.float32, device=t.device)
    out, ws = buf[0], buf[1:]
    if k == 0:
        return out
    fn = _build.entry("colsum", "colsum_f32", _ARGS)
    err = fn(t.data_ptr(), ws.data_ptr(), out.data_ptr(), n, k, s,
             torch.cuda.current_stream(t.device).cuda_stream)
    _build.check_launch(err, "colsum")
    LAUNCHES["colsum"] += 1
    return out
