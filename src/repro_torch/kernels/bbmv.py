"""The block-banded layout and the CUDA launcher of its matvec
(``csrc/bbmv.cu``).

Port of ``repro/kernels/bbmv.py``: band tiles
``A_bands[nb, 2*bands+1, block, block]`` hold the ``block x block`` tiles
of block row ``i`` at block columns ``i - bands .. i + bands``; tiles whose
block column falls outside the matrix are zero.  ``bbmv`` computes
``y_i = sum_d A_bands[i, d] @ x[block i + d - bands]``, one CTA per
(column tile, block row), register-tiled and double-buffered; the kernel
design and what bounds it are in the source's header note.

``bbmv`` takes tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types) and launches on PyTorch's current
stream.  It adds one to ``LAUNCHES`` where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import band_valid

LAUNCHES = {"bbmv": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
# Every C entry of csrc/bbmv.cu this launcher loads, with its argument
# types.
C_ENTRIES = {f"bbmv_{suffix}": _ARGS
             for suffix in _build.VALUE_SUFFIX.values()}


def dense_to_bands(A: torch.Tensor, *, bands: int, block: int) -> torch.Tensor:
    """Pack the block band of dense ``A`` (n, n) into tiles (nb, 2*bands+1,
    block, block) on A's device, out-of-range tiles zero.  One gather over
    a (nb, nb, block, block) view of A."""
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n or n % block:
        raise ValueError(f"A {tuple(A.shape)} must be square with n a "
                         f"multiple of block ({block})")
    nb = n // block
    At = A.reshape(nb, block, nb, block).transpose(1, 2)
    rows = torch.arange(nb, device=A.device)[:, None]
    cols = rows + torch.arange(-bands, bands + 1, device=A.device)[None, :]
    tiles = At[rows, cols.clamp(0, nb - 1)]
    return tiles.masked_fill(~band_valid(nb, bands, A.device)[:, :, None, None],
                             0)


def pack_bands_local(A_bands: torch.Tensor, bands: int) -> torch.Tensor:
    """The band tiles the fused sweep reads: tiles whose block column falls
    outside [0, nb) are zeroed, so the kernel needs no validity branch
    (the reference's ``pack_bands_local`` for one worker owning every block
    row: ``lo_block = 0``, ``nb_local = nb``)."""
    valid = band_valid(A_bands.shape[0], bands, A_bands.device)
    return A_bands.masked_fill(~valid[:, :, None, None], 0)


def bbmv(A_bands, x, *, bands: int, block: int, _col_warps: int = 0):
    """``y = A @ x`` (nb*block, k) f32 on the card.

    ``_col_warps`` (1, 2 or 4) sets the column tile to 32 times that many
    columns, for ``chip_smoke.py``, which holds two tiles of 32 bitwise
    against one of 64; 0 takes the kernel's own rule."""
    nb = A_bands.shape[0]
    k = x.shape[1]
    y = torch.empty((nb * block, k), dtype=torch.float32, device=x.device)
    if nb == 0 or k == 0:
        return y
    fn = _build.c_entry("bbmv", "bbmv", A_bands.dtype, None, _ARGS)
    err = fn(A_bands.data_ptr(), x.data_ptr(), y.data_ptr(), nb, bands, block,
             k, int(_col_warps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "bbmv")
    LAUNCHES["bbmv"] += 1
    return y
