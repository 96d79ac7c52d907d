"""CUDA launchers of the fused sequential sweeps (``csrc/sweep_csr.cu``).

Port of ``repro/kernels/sweep_csr.py::sweep_rows_gs`` / ``::sweep_rows_rk``
/ ``::sweep_rows_rk_delta``: a whole run of ``len(picks)`` sequential row
updates in one launch, one warp per RHS column.  ``sweep_rows_block_gs``
is the port's own block mode of the GS sweep (block GS on CSR, which the
reference runs as a ``lax.scan`` over densified row panels): a pick
updates an aligned panel of ``block`` rows, one CTA per RHS column, its
row windows streamed through a ring in shared memory (``block_plan``).
The kernel designs and what bounds them are in the source's notes.

Each sweep has two paths, chosen here by size (``fits_shared``,
``block_plan``): a CTA holds one column of the iterate (and of the delta
carry) in shared memory when all its rows fit the opt-in capacity (beside
the block sweep's ring), else they stay in global memory.  Both paths are
bitwise equal on the same inputs.

These functions take tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types, int32 picks) and launch on
PyTorch's current stream.  ``limit`` bounds the pick ids: each C entry
first launches a check kernel that asserts ``0 <= pick < limit`` on the
device, then the sweep.  Each adds one to its entry of ``LAUNCHES``
where it launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

LAUNCHES = {"sweep_rows_gs": 0, "sweep_rows_rk": 0,
            "sweep_rows_rk_delta": 0, "sweep_rows_block_gs": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GS_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]
_RK_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
_RK_DELTA_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
_BLOCK_GS_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                  _I, _I, _P]
_CAPACITY_ARGS = [_I, ctypes.POINTER(_I)]
_KERNEL_ARGS = {"sweep_rows_gs": _GS_ARGS, "sweep_rows_rk": _RK_ARGS,
                "sweep_rows_rk_delta": _RK_DELTA_ARGS,
                "sweep_rows_block_gs": _BLOCK_GS_ARGS}
# Every C entry of csrc/sweep_csr.cu these launchers load, with its
# argument types.
C_ENTRIES = {f"{kernel}_{suffix}": args
             for kernel, args in _KERNEL_ARGS.items()
             for suffix in _build.SUFFIX.values()}
C_ENTRIES["sweep_shared_capacity"] = _CAPACITY_ARGS

_capacity: dict[int, int] = {}

RING_WARPS = 8       # consumer warps of the block sweep at most (kRingWarps)
RING_STAGES = 2      # stages of its ring (kRingStages)
MIN_TILE_ROWS = 32   # the shared-memory path's ring holds tiles of this
GLOBAL_RING_BLOCK = 8  # the global path's ring runs picks of at most this


def fits_shared(rows: int, capacity: int, carries: int = 1) -> bool:
    """Whether a sweep takes its shared-memory path: one column of each of
    its ``carries`` (1: x; 2: x and the RK delta d), all ``rows`` rows (GS:
    ``write_base + r`` may be any of them; block GS: n rows and the pick's
    ``block`` staged gammas) at 4 bytes each, within ``capacity`` bytes.
    Otherwise they stay in global memory."""
    return 4 * rows * carries <= capacity


def _use_shared(x, carries: int, override: bool | None) -> bool:
    if override is not None:
        return bool(override)
    return fits_shared(x.shape[0], shared_capacity(x.device), carries)


def shared_capacity(device: torch.device) -> int:
    """Bytes of shared memory one CTA may opt into on ``device``
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _capacity:
        fn = _build.entry("sweep_csr", "sweep_shared_capacity",
                          _CAPACITY_ARGS)
        out = ctypes.c_int(0)
        _build.check_launch(fn(index, ctypes.byref(out)),
                            "sweep_shared_capacity")
        _capacity[index] = out.value
    return _capacity[index]


def sweep_rows_gs(vals, cols, b, x, picks, *, beta: float, write_base: int,
                  limit: int, _shared: bool | None = None):
    """GS sweep on the card.  Returns a new x (``x`` cloned, then updated
    in place by the kernel).

    ``_shared`` overrides the size rule (True: the shared-memory path,
    False: the global path), for ``chip_smoke.py``, which holds the two
    paths against each other."""
    n, k = x.shape
    width = vals.shape[1]
    out = x.clone()
    if picks.numel() == 0 or k == 0:
        return out
    shared = _use_shared(x, 1, _shared)
    fn = _build.c_entry("sweep_csr", "sweep_rows_gs", vals.dtype, cols.dtype,
                        _GS_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), b.data_ptr(), out.data_ptr(),
             picks.data_ptr(), width, n, k, picks.numel(), int(limit),
             int(write_base), float(beta), int(shared),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "sweep_rows_gs")
    LAUNCHES["sweep_rows_gs"] += 1
    return out


def sweep_rows_rk(vals, cols, b, rn, x, picks, *, beta: float, limit: int,
                  _shared: bool | None = None):
    """Kaczmarz sweep on the card.  Returns a new x (``x`` cloned, then
    updated in place by the kernel).  ``_shared`` overrides the size rule,
    as in ``sweep_rows_gs``."""
    n, k = x.shape
    width = vals.shape[1]
    out = x.clone()
    if picks.numel() == 0 or k == 0:
        return out
    shared = _use_shared(x, 1, _shared)
    fn = _build.c_entry("sweep_csr", "sweep_rows_rk", vals.dtype, cols.dtype,
                        _RK_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), b.data_ptr(), rn.data_ptr(),
             out.data_ptr(), picks.data_ptr(), width, n, k, picks.numel(),
             int(limit), float(beta), int(shared),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "sweep_rows_rk")
    LAUNCHES["sweep_rows_rk"] += 1
    return out


def sweep_rows_rk_delta(vals, cols, b, rn, x, d, picks, *, beta: float,
                        limit: int, _shared: bool | None = None):
    """Two-carry Kaczmarz sweep on the card.  Returns new ``(x, d)``
    (both cloned, then updated in place by the kernel).  ``_shared``
    overrides the size rule, as in ``sweep_rows_gs``."""
    n, k = x.shape
    width = vals.shape[1]
    x_out, d_out = x.clone(), d.clone()
    if picks.numel() == 0 or k == 0:
        return x_out, d_out
    shared = _use_shared(x, 2, _shared)
    fn = _build.c_entry("sweep_csr", "sweep_rows_rk_delta", vals.dtype,
                        cols.dtype, _RK_DELTA_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), b.data_ptr(), rn.data_ptr(),
             x_out.data_ptr(), d_out.data_ptr(), picks.data_ptr(), width, n, k,
             picks.numel(), int(limit), float(beta), int(shared),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "sweep_rows_rk_delta")
    LAUNCHES["sweep_rows_rk_delta"] += 1
    return x_out, d_out


class BlockPlan(NamedTuple):
    """How ``sweep_rows_block_gs`` runs (``csrc/sweep_csr.cu``'s block GS
    note): x in shared memory or not; ``lanes`` lanes a row, ``warps``
    consumer warps; a ring of ``RING_STAGES`` stages of ``tile_rows`` rows
    (``tile_rows`` 0: the first design, no ring)."""
    shared: bool
    lanes: int
    warps: int
    tile_rows: int


def ring_region(rows: int, width: int, itemsize: int) -> int:
    """Bytes of a stage region: ``rows`` row windows of ``itemsize``-byte
    elements at an offset under 16 bytes, rounded up to 16
    (``csrc/sweep_csr.cu::ring_region``)."""
    return (rows * width * itemsize + 30) // 16 * 16


def ring_bytes(n: int, width: int, tile_rows: int, vbytes: int, ibytes: int,
               shared: bool) -> int:
    """Dynamic shared memory of the ring kernel: the stages' barriers, a
    column of x on the shared-memory path, and ``RING_STAGES`` stages of
    values, ids and the rows' b values (``ring_smem_bytes``)."""
    xb = (4 * n + 15) // 16 * 16 if shared else 0
    return 16 * RING_STAGES + xb + RING_STAGES * (
        ring_region(tile_rows, width, vbytes)
        + ring_region(tile_rows, width, ibytes)
        + (4 * tile_rows + 15) // 16 * 16)


def block_plan(n: int, width: int, block: int, vbytes: int, ibytes: int,
               capacity: int, *, shared: bool | None = None) -> BlockPlan:
    """The block sweep's plan, by size alone.

    Warps: ``min(RING_WARPS, block)`` (at block 8 a warp a row beat one
    warp holding all eight rows: PERF.md).  Rows a warp: the least of 1,
    8, 16, 32 that covers ``ceil(block / warps)``, so ``lanes = 32 /
    rows``.  x goes to shared memory when the ring of ``min(block, pass,
    MIN_TILE_ROWS)`` rows a stage fits beside it (``shared`` overrides;
    a pass is ``warps * rows`` rows).  A tile is the most rows, up to a
    pass and the block, whose ring fits beside x.  On the global path a
    pick of more than ``GLOBAL_RING_BLOCK`` rows runs the first design
    (``tile_rows`` 0: there the ring was no faster, PERF.md), and so does
    a row too wide for a ring of one-row stages.  The first design holds
    x in shared memory when x and the block's gammas fit
    (``fits_shared(n + block, ...)``)."""
    warps = min(RING_WARPS, block)
    need = -(-block // warps)
    rows = next(r for r in (1, 8, 16, 32) if need <= r or r == 32)
    full = min(block, warps * rows)

    def fits(t, x_shared):
        return ring_bytes(n, width, t, vbytes, ibytes, x_shared) <= capacity

    x_shared = (fits(min(full, MIN_TILE_ROWS), True) if shared is None
                else bool(shared))
    tile = full if x_shared or block <= GLOBAL_RING_BLOCK else 0
    while tile > 0 and not fits(tile, x_shared):
        tile -= 1
    if tile == 0:
        first = (fits_shared(n + block, capacity) if shared is None
                 else bool(shared))
        return BlockPlan(first, 32, RING_WARPS, 0)
    return BlockPlan(x_shared, 32 // rows, warps, tile)


def sweep_rows_block_gs(vals, cols, b, x, blocks, *, block: int, beta: float,
                        limit: int, _shared: bool | None = None):
    """Block GS sweep on the card.  Returns a new x (``x`` cloned, then
    updated in place by the kernel).

    ``block_plan`` sets the path and the ring; a (k, block) scratch
    allocated here holds the gammas of the first design's global path and
    of picks spanning several tiles.  The ring's bulk copies need
    16-byte-aligned windows: a view that starts elsewhere is copied first.
    ``_shared`` overrides the size rule, as in ``sweep_rows_gs``."""
    n, k = x.shape
    width = vals.shape[1]
    out = x.clone()
    if blocks.numel() == 0 or k == 0:
        return out
    plan = block_plan(n, width, block, vals.element_size(),
                      cols.element_size(), shared_capacity(x.device),
                      shared=_shared)
    if plan.tile_rows and (vals.data_ptr() % 16 or cols.data_ptr() % 16):
        vals, cols = vals.clone(), cols.clone()
    staged = (not plan.shared if plan.tile_rows == 0
              else plan.tile_rows < block)
    scratch = (torch.empty((k, block), dtype=torch.float32, device=x.device)
               if staged else None)
    fn = _build.c_entry("sweep_csr", "sweep_rows_block_gs", vals.dtype,
                        cols.dtype, _BLOCK_GS_ARGS)
    err = fn(vals.data_ptr(), cols.data_ptr(), b.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             blocks.data_ptr(), width, n, k, blocks.numel(), int(limit),
             int(block), float(beta), int(plan.shared), plan.lanes,
             plan.warps, plan.tile_rows,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "sweep_rows_block_gs")
    LAUNCHES["sweep_rows_block_gs"] += 1
    return out
