"""CUDA launchers of the CSR matvecs (``csrc/spmv_csr.cu``).

Port of ``repro/kernels/spmv_csr.py::spmv_csr_sliced`` /
``::spmv_csr_sliced_prefetch`` (the sliced-ELL view: one thread per output
element, each row window contracted in slot order) and ``::spmv_csr`` /
``::spmv_csr_prefetch`` (the flat panel-aligned layout: one CTA per panel,
a segment sum over the panel's slots in slot order).  Each predicated
variant writes zeros for empty panels and is bitwise equal to its plain
twin.  The kernel design and what bounds it are in the source's header
note.

These functions take tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types, int32 ``row_id`` and
``panel_nnz``) and launch on PyTorch's current stream.  Each adds one to
its entry of ``LAUNCHES`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"spmv_csr_sliced": 0, "spmv_csr_sliced_prefetch": 0,
            "spmv_csr": 0, "spmv_csr_prefetch": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SLICED_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P]
_PREFETCH_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_SEGSUM_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_SEGSUM_PREFETCH_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def spmv_csr_sliced(vals, cols, x, *, m: int):
    """``y = A @ x`` (m, k) f32 on the card."""
    width = vals.shape[1]
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr_sliced", vals.dtype,
                        cols.dtype, _SLICED_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
             m, width, k, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr_sliced")
    LAUNCHES["spmv_csr_sliced"] += 1
    return y


def spmv_csr_sliced_prefetch(vals, cols, panel_nnz, x, *, m: int,
                             rows_per_panel: int):
    """``y = A @ x`` (m, k) f32 on the card, empty panels written as 0."""
    width = vals.shape[1]
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr_sliced_prefetch", vals.dtype,
                        cols.dtype, _PREFETCH_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), panel_nnz.data_ptr(),
             x.data_ptr(), y.data_ptr(), m, width, k, rows_per_panel,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr_sliced_prefetch")
    LAUNCHES["spmv_csr_sliced_prefetch"] += 1
    return y


def spmv_csr(data, indices, row_id, x, *, m: int, rows_per_panel: int,
             panel_width: int):
    """``y = A @ x`` (m, k) f32 on the card by a segment sum over the flat
    panel-aligned layout."""
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr", data.dtype, indices.dtype,
                        _SEGSUM_ARGS)
    err = fn(data.data_ptr(), indices.data_ptr(), row_id.data_ptr(),
             x.data_ptr(), y.data_ptr(), m, k, rows_per_panel, panel_width,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr")
    LAUNCHES["spmv_csr"] += 1
    return y


def spmv_csr_prefetch(data, indices, row_id, panel_nnz, x, *, m: int,
                      rows_per_panel: int, panel_width: int):
    """``spmv_csr`` on the card with the rows of empty panels written as 0
    and their slots never read."""
    k = x.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_csr", "spmv_csr_prefetch", data.dtype,
                        indices.dtype, _SEGSUM_PREFETCH_ARGS)
    err = fn(data.data_ptr(), indices.data_ptr(), row_id.data_ptr(),
             panel_nnz.data_ptr(), x.data_ptr(), y.data_ptr(), m, k,
             rows_per_panel, panel_width,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_csr_prefetch")
    LAUNCHES["spmv_csr_prefetch"] += 1
    return y
