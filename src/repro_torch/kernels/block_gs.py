"""CUDA launcher of the dense block Gauss-Seidel sweep (``csrc/block_gs.cu``).

Port of ``repro/kernels/block_gs.py::block_gs_sweep``: a whole run of
``len(blocks)`` sequential block-row updates of x in one cooperative
launch, the n-reduction of each step split over the card's CTAs in a fixed
order.  The kernel design and what bounds it are in the source's header
note.

This function takes tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types, int32 block ids) and launches on
PyTorch's current stream.  ``limit`` bounds the block ids: the C entry
first launches a check kernel that asserts ``0 <= id < limit`` on the
device, then the sweep.  It adds one to ``LAUNCHES`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"block_gs_sweep": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]


def _scratch_floats(n: int, block: int, k: int) -> int:
    """Size of the kernel's partial-sum scratch, as the source defines it."""
    fn = _build.library("block_gs").block_gs_scratch_floats
    fn.argtypes = [_I, _I, _I]
    fn.restype = ctypes.c_longlong
    return int(fn(n, block, k))


def block_gs_sweep(A, b, x, blocks, *, block: int, beta: float, limit: int):
    """Dense block-GS sweep on the card.  Returns a new x (``x`` cloned,
    then updated in place by the kernel)."""
    n, k = x.shape
    out = x.clone()
    if blocks.numel() == 0 or k == 0:
        return out
    part = torch.empty(_scratch_floats(n, block, k), dtype=torch.float32,
                       device=x.device)
    fn = _build.c_entry("block_gs", "block_gs_sweep", A.dtype, None, _ARGS)
    err = fn(A.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(),
             blocks.data_ptr(), blocks.numel(), int(limit), n, block, k,
             float(beta), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "block_gs_sweep")
    LAUNCHES["block_gs_sweep"] += 1
    return out
