"""CUDA launcher of the fused banded block-GS sweep (``csrc/banded_gs.cu``).

Port of ``repro/kernels/banded_gs.py::banded_gs_sweep``: a whole run of
``len(picks)`` sequential block-row updates of a halo-padded window in one
launch, one CTA per tile of RHS columns.  The kernel design and what
bounds it are in the source's header note.

``banded_gs_sweep`` takes tensors already checked by ``kernels/ops.py``
(CUDA, contiguous, matching shapes and types, int32 picks) and launches on
PyTorch's current stream.  ``limit`` bounds the pick ids: the C entry first
launches a check kernel that asserts ``0 <= pick < limit`` on the device,
then the sweep.  It adds one to ``LAUNCHES`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"banded_gs_sweep": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]


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
