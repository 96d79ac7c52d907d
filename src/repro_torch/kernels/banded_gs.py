"""CUDA launchers of the fused banded sweeps (``csrc/banded_gs.cu``).

Port of ``repro/kernels/banded_gs.py::banded_gs_sweep`` / ``::banded_rk_sweep``:
a whole run of ``len(picks)`` sequential block-row updates of a
halo-padded window (block GS; masked block Kaczmarz on the window and a
delta window) in one launch, one CTA per tile of RHS columns.  The kernel
design and what bounds it are in the source's header note.

These functions take tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types, int32 picks and gates) and launch
on PyTorch's current stream.  ``limit`` bounds the pick ids: each C entry
first launches a check kernel that asserts ``0 <= pick < limit`` on the
device, then the sweep.  Each adds one to its entry of ``LAUNCHES`` where
it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"banded_gs_sweep": 0, "banded_rk_sweep": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
_RK_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]


def banded_gs_sweep(A_bands, b, xw, picks, *, block: int, bands: int,
                    beta: float, limit: int):
    """Banded GS sweep on the card.  Returns a new window (``xw`` cloned,
    then updated in place by the kernel)."""
    k = b.shape[1]
    out = xw.clone()
    if picks.numel() == 0 or k == 0:
        return out
    fn = _build.c_entry("banded_gs", "banded_gs_sweep", A_bands.dtype, None,
                        _ARGS)
    err = fn(A_bands.data_ptr(), b.data_ptr(), out.data_ptr(),
             picks.data_ptr(), picks.numel(), int(limit), bands, block, k,
             float(beta), torch.cuda.current_stream(xw.device).cuda_stream)
    _build.check_launch(err, "banded_gs_sweep")
    LAUNCHES["banded_gs_sweep"] += 1
    return out


def banded_rk_sweep(A_bands, b, rn, xw, dw, picks, gates, *, block: int,
                    bands: int, beta: float, limit: int):
    """Masked banded Kaczmarz sweep on the card.  Returns new ``(xw, dw)``
    (both cloned, then updated in place by the kernel)."""
    k = b.shape[1]
    xw_out, dw_out = xw.clone(), dw.clone()
    if picks.numel() == 0 or k == 0:
        return xw_out, dw_out
    fn = _build.c_entry("banded_gs", "banded_rk_sweep", A_bands.dtype, None,
                        _RK_ARGS)
    err = fn(A_bands.data_ptr(), b.data_ptr(), rn.data_ptr(),
             xw_out.data_ptr(), dw_out.data_ptr(), picks.data_ptr(),
             gates.data_ptr(), picks.numel(), int(limit), bands, block, k,
             float(beta), torch.cuda.current_stream(xw.device).cuda_stream)
    _build.check_launch(err, "banded_rk_sweep")
    LAUNCHES["banded_rk_sweep"] += 1
    return xw_out, dw_out
