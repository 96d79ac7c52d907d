"""CUDA launcher of the ELL matvec (``csrc/spmv_ell.cu``).

Port of ``repro/kernels/spmv_ell.py::spmv_ell``: the row-window kernel
of the sliced CSR matvec (one thread an output, each row window
contracted in slot order and stopped after the row's first padding slot
when its count is given: ``kernels/spmv_csr.py::row_extent``).  The
kernel design and what bounds it are in the source's header note.

``spmv_ell`` takes tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types) and launches on PyTorch's current
stream.  It adds one to ``LAUNCHES`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"spmv_ell": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P]


def spmv_ell(vals, cols, x, *, counts=None):
    """``y = A @ x`` (rows, k) f32 on the card; ``counts`` (int32 (rows,)
    or None) stops each row's chain after its first padding slot."""
    n, width = vals.shape
    k = x.shape[1]
    y = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return y
    fn = _build.c_entry("spmv_ell", "spmv_ell", vals.dtype, cols.dtype, _ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(),
             None if counts is None else counts.data_ptr(), x.data_ptr(),
             y.data_ptr(), n, width, k,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "spmv_ell")
    LAUNCHES["spmv_ell"] += 1
    return y
