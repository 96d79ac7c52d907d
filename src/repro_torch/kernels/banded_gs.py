"""CUDA launchers of the fused banded sweeps (``csrc/banded_gs.cu``).

Port of ``repro/kernels/banded_gs.py::banded_gs_sweep`` / ``::banded_rk_sweep``:
a whole run of ``len(picks)`` sequential block-row updates of a
halo-padded window (block GS; masked block Kaczmarz on the window and a
delta window) in one launch, one CTA per RHS column, a producer warp
streaming the picks' tiles through a ring of shared-memory stages.  The
kernel design and what bounds it are in the source's header note.

Each sweep has two paths, chosen here by size (``fits_shared``): a CTA
holds its column of the window in shared memory when it fits the opt-in
capacity beside the stages, else the window stays in global memory.  Both
paths are bitwise equal on the same inputs.

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

from repro_torch.kernels import _build, sweep_csr

LAUNCHES = {"banded_gs_sweep": 0, "banded_rk_sweep": 0}

# csrc/banded_gs.cu's limits and shared-memory layout
STAGE_ROWS = (32, 16, 8, 4)   # tile rows a stage holds, largest first (a
                              # stage of 4 rows or fewer takes the same bytes)
SLICES = 4                    # bulk copies a stage
CONSUMERS = 15                # most consumer warps, one a band up to 7 bands
MAX_STAGES = 16               # the ring's length, unless the bands need more

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]
_RK_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I,
            _P]
# Every C entry of csrc/banded_gs.cu these launchers load, with its
# argument types.
C_ENTRIES = {f"{kernel}_{suffix}": args
             for kernel, args in (("banded_gs_sweep", _ARGS),
                                  ("banded_rk_sweep", _RK_ARGS))
             for suffix in _build.VALUE_SUFFIX.values()}


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def stage_bytes(block: int, itemsize: int, rows: int) -> int:
    """Bytes of one stage of ``rows`` tile rows: ``SLICES`` slices of
    ceil(rows / SLICES) rows (each rounded up to 16 bytes), 16 bytes apart
    beyond that."""
    return SLICES * (-(-rows // SLICES) * _round16(block * itemsize) + 16)


def smem_bytes(block: int, bands: int, itemsize: int, rows: int, stages: int,
               rows_w: int, shared: bool) -> int:
    """Dynamic shared memory of one CTA (``band_layout`` in the source):
    two mbarriers a stage (16 bytes, rounded up to 256), ``stages`` stages
    of ``rows`` tile rows, the parts and g of a row group, the Kaczmarz
    sums of the bands past the first ``CONSUMERS``, then the window column
    of ``rows_w`` rows (the shared-memory path) or a pick's 2*bands+1
    blocks of it (the global path)."""
    width = 2 * bands + 1
    return (256 * -(-stages // 16)
            + stages * stage_bytes(block, itemsize, rows)
            + _round16(4 * 2 * width * rows) + _round16(4 * block)
            + _round16(4 * max(0, width - CONSUMERS) * block)
            + _round16(4 * (rows_w if shared else width * block)))


def _ring(rows_w: int, block: int, bands: int, itemsize: int, capacity: int,
          shared: bool, rows: int) -> int:
    """Stages of ``rows`` tile rows that fit beside the rest, at most
    ``MAX_STAGES`` or 2*bands+2 if that is more (0 if none fits)."""
    stages = max(MAX_STAGES, 2 * bands + 2)
    while stages and smem_bytes(block, bands, itemsize, rows, stages,
                                rows_w, shared) > capacity:
        stages -= 1
    return stages


def fits_shared(rows_w: int, block: int, bands: int, itemsize: int,
                capacity: int) -> bool:
    """Whether a sweep takes its shared-memory path: the window column
    (``rows_w`` rows at 4 bytes) beside 2*bands+2 stages of 32 tile rows
    within ``capacity`` bytes.  Otherwise it stays in global memory."""
    return _ring(rows_w, block, bands, itemsize, capacity, True,
                 STAGE_ROWS[0]) >= 2 * bands + 2


def plan(rows_w: int, block: int, bands: int, itemsize: int, capacity: int,
         shared: bool) -> tuple[int, int]:
    """``(rows, stages)`` of the ring: the largest stage (up to 32 tile
    rows) of which at least 2*bands+2 fit beside the rest (the Kaczmarz
    sweep holds a row group's 2*bands+1 stages at once), and as many of
    them as fit, at most ``MAX_STAGES`` or 2*bands+2.  Raises if none
    fits."""
    for rows in STAGE_ROWS:
        stages = _ring(rows_w, block, bands, itemsize, capacity, shared, rows)
        if stages >= 2 * bands + 2:
            return rows, stages
    raise ValueError(f"banded sweep: no stage ring fits {capacity} bytes of "
                     f"shared memory at block {block}, bands {bands}"
                     + (f" beside a {rows_w}-row window" if shared else ""))


def _launch_plan(A_bands, xw, block, bands, shared):
    rows_w = xw.shape[0]
    itemsize = A_bands.element_size()
    capacity = sweep_csr.shared_capacity(xw.device)
    if shared is None:
        shared = fits_shared(rows_w, block, bands, itemsize, capacity)
    rows, stages = plan(rows_w, block, bands, itemsize, capacity, shared)
    return int(bool(shared)), rows, stages


def banded_gs_sweep(A_bands, b, xw, picks, *, block: int, bands: int,
                    beta: float, limit: int, _shared: bool | None = None):
    """Banded GS sweep on the card.  Returns a new window (``xw`` cloned,
    then updated in place by the kernel).

    ``_shared`` overrides the size rule (True: the shared-memory path,
    False: the global path), for ``chip_smoke.py`` and
    ``tune/banded_probe.py``, which hold the two paths against each
    other."""
    k = b.shape[1]
    out = xw.clone()
    if picks.numel() == 0 or k == 0:
        return out
    shared, rows, stages = _launch_plan(A_bands, xw, block, bands, _shared)
    fn = _build.c_entry("banded_gs", "banded_gs_sweep", A_bands.dtype, None,
                        _ARGS)
    err = fn(A_bands.data_ptr(), b.data_ptr(), out.data_ptr(),
             picks.data_ptr(), picks.numel(), int(limit), bands, block, k,
             float(beta), shared, rows, stages,
             torch.cuda.current_stream(xw.device).cuda_stream)
    _build.check_launch(err, "banded_gs_sweep")
    LAUNCHES["banded_gs_sweep"] += 1
    return out


def banded_rk_sweep(A_bands, b, rn, xw, dw, picks, gates, *, block: int,
                    bands: int, beta: float, limit: int,
                    _shared: bool | None = None):
    """Masked banded Kaczmarz sweep on the card.  Returns new ``(xw, dw)``
    (both cloned, then updated in place by the kernel).  ``_shared``
    overrides the size rule, as in ``banded_gs_sweep``."""
    k = b.shape[1]
    xw_out, dw_out = xw.clone(), dw.clone()
    if picks.numel() == 0 or k == 0:
        return xw_out, dw_out
    shared, rows, stages = _launch_plan(A_bands, xw, block, bands, _shared)
    fn = _build.c_entry("banded_gs", "banded_rk_sweep", A_bands.dtype, None,
                        _RK_ARGS)
    err = fn(A_bands.data_ptr(), b.data_ptr(), rn.data_ptr(),
             xw_out.data_ptr(), dw_out.data_ptr(), picks.data_ptr(),
             gates.data_ptr(), picks.numel(), int(limit), bands, block, k,
             float(beta), shared, rows, stages,
             torch.cuda.current_stream(xw.device).cuda_stream)
    _build.check_launch(err, "banded_rk_sweep")
    LAUNCHES["banded_rk_sweep"] += 1
    return xw_out, dw_out
