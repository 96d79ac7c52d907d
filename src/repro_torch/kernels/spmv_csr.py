"""CUDA launchers of the CSR matvecs (``csrc/spmv_csr.cu``).

Port of ``repro/kernels/spmv_csr.py::spmv_csr_sliced`` /
``::spmv_csr_sliced_prefetch`` (the sliced-ELL view: one thread an output,
each row window contracted in slot order and stopped after the row's
first padding slot when its count is given; the row-window kernel the ELL
matvec shares) and ``::spmv_csr`` / ``::spmv_csr_prefetch`` (the flat
panel-aligned layout: one thread an output, each row's slots found
through ``row_start``/``row_nnz`` and chained in slot order, row 0 adding
panel 0's tail term once where ``panel0_tail``).  Each predicated variant
writes zeros for empty panels and is bitwise equal to its plain twin for
finite x: a NaN or inf in x's row 0 reaches the rows of an empty panel
through its padding slots (value +0, column 0) in the plain twin only.
The kernel design and what bounds it are in the source's header note.

These functions take tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types, int32 ``row_start``, ``row_nnz``,
``panel_nnz`` and ``counts``) and launch on PyTorch's current stream.
Each adds one to its entry of ``LAUNCHES`` where it launches.
``row_extent`` is the rule the per-row counts follow.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"spmv_csr_sliced": 0, "spmv_csr_sliced_prefetch": 0,
            "spmv_csr": 0, "spmv_csr_prefetch": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SLICED_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
_PREFETCH_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_SEGSUM_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
_SEGSUM_PREFETCH_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def row_extent(vals, cols):
    """Per row of (rows, width) windows, the slots before the row's
    padding: its longest suffix of slots that hold the value +0 (its bits)
    and the column of the row's last slot.  A kernel given these counts
    chains each row up to and including its first padding slot, which
    gives the bits of chaining every slot (``rw_stop`` in
    ``csrc/common.cuh``).  The operators' counts (CSR ``row_nnz``, ELL
    ``row_counts``) are this for the windows they build.  int32 (rows,)."""
    rows, width = vals.shape
    if width == 0:
        return torch.zeros(rows, dtype=torch.int32, device=vals.device)
    bits = vals.view(torch.int16 if vals.element_size() == 2 else torch.int32)
    match = (bits == 0) & (cols == cols[:, -1:])
    run = match.flip(1).to(torch.int32).cumprod(1).sum(1)
    return (width - run).to(torch.int32)


# The stopped kernel (counts given) pays a load of the row's count ahead
# of each chain: on an H100 rows without padding ran 14% slower with it,
# while skipping the main SPD view's 41% of padding saved 22% (PERF.md;
# tune/spmv_probe.py --variants stop_everywhere,all_slots).  The operators
# pass their counts when at least this share of their window slots is
# padding.  On ELL at truncated widths the counts cost 1.8% at 18%
# padding and saved 2.8% at 25% (tune/spmv_probe.py --padding-sweep).
STOP_PADDING_SHARE = 0.25


def worth_stopping(rows: int, width: int, stored: int, k: int) -> bool:
    """Whether a matvec over (rows, width) windows holding ``stored``
    entries, with k columns, takes the stopped kernel: at least
    ``STOP_PADDING_SHARE`` of the slots are padding, and its rows x k
    outputs fit the kernel's 32-bit index (larger products take the
    64-bit kernel that reads every slot)."""
    slots = rows * width
    return (slots > 0 and slots - stored >= STOP_PADDING_SHARE * slots
            and rows * k < 2 ** 32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def spmv_csr_sliced(vals, cols, x, *, m: int, counts=None):
    """``y = A @ x`` (m, k) f32 on the card; ``counts`` (int32 (m,) or
    None) stops each row's chain after its first padding slot."""
    width = vals.shape[1]
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr_sliced", vals.dtype,
                        cols.dtype, _SLICED_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), _ptr(counts), x.data_ptr(),
             y.data_ptr(), m, width, k,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr_sliced")
    LAUNCHES["spmv_csr_sliced"] += 1
    return y


def spmv_csr_sliced_prefetch(vals, cols, panel_nnz, x, *, m: int,
                             rows_per_panel: int, counts=None):
    """``y = A @ x`` (m, k) f32 on the card, empty panels written as 0."""
    width = vals.shape[1]
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr_sliced_prefetch", vals.dtype,
                        cols.dtype, _PREFETCH_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), _ptr(counts),
             panel_nnz.data_ptr(), x.data_ptr(), y.data_ptr(), m, width, k,
             rows_per_panel, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr_sliced_prefetch")
    LAUNCHES["spmv_csr_sliced_prefetch"] += 1
    return y


def spmv_csr(data, indices, row_start, row_nnz, x, *, m: int,
             panel0_tail: bool):
    """``y = A @ x`` (m, k) f32 on the card by a segment sum over the flat
    panel-aligned layout, each row's slots found through its layout."""
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr", data.dtype, indices.dtype,
                        _SEGSUM_ARGS)
    err = fn(data.data_ptr(), indices.data_ptr(), row_start.data_ptr(),
             row_nnz.data_ptr(), x.data_ptr(), y.data_ptr(), m, k,
             int(panel0_tail), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr")
    LAUNCHES["spmv_csr"] += 1
    return y


def spmv_csr_prefetch(data, indices, row_start, row_nnz, panel_nnz, x, *,
                      m: int, rows_per_panel: int, panel0_tail: bool):
    """``spmv_csr`` on the card with the rows of empty panels written as 0
    and their slots never read."""
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr_prefetch", data.dtype,
                        indices.dtype, _SEGSUM_PREFETCH_ARGS)
    err = fn(data.data_ptr(), indices.data_ptr(), row_start.data_ptr(),
             row_nnz.data_ptr(), panel_nnz.data_ptr(), x.data_ptr(),
             y.data_ptr(), m, k, rows_per_panel, int(panel0_tail),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr_prefetch")
    LAUNCHES["spmv_csr_prefetch"] += 1
    return y
