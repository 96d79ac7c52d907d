"""CUDA launcher of the dense block Gauss-Seidel sweep (``csrc/block_gs.cu``).

Port of ``repro/kernels/block_gs.py::block_gs_sweep``: a whole run of
``len(blocks)`` sequential block-row updates of x in one cooperative
launch, one CTA an SM.  Each CTA owns fixed units (a column tile of x, a
256-column slice of A, a row group of the block), streams their panel
rows through a ring of shared-memory stages and hands each step's parts
to reducer warps through counters in global memory.  The kernel design
and what bounds it are in the source's header note.

This function takes tensors already checked by ``kernels/ops.py`` (CUDA,
contiguous, matching shapes and types, int32 block ids) and launches on
PyTorch's current stream.  ``limit`` bounds the block ids: the C entry
first launches a check kernel that asserts ``0 <= id < limit`` on the
device, then the sweep.  It adds one to ``LAUNCHES`` where it launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

LAUNCHES = {"block_gs_sweep": 0}

# csrc/block_gs.cu's constants
SLICE = 256        # columns of A a part sums: fixes the reduction order
ROWS = 32          # rows of the block a unit holds (fewer for a smaller block)
MAX_COLS = 64      # columns of x a unit holds
MAX_STAGES = 8     # panel stages a CTA's ring holds at most
BAR_BYTES = 256    # the mbarriers of the stages and of the parts' hand-offs
DEPTH = 4          # steps of parts in flight (the scratch ring)
HEADER = 1024      # floats of counters ahead of the parts, zeroed a launch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
# The C entries of csrc/block_gs.cu this module loads that return int,
# with their argument types (block_gs_scratch_floats and block_gs_plan
# return long long and nothing, and are loaded apart).
C_ENTRIES = {f"block_gs_sweep_{sfx}": _ARGS
             for sfx in _build.VALUE_SUFFIX.values()}


class Plan(NamedTuple):
    """A launch's layout (``make_plan`` in the source)."""
    slices: int    # 256-column slices of A
    rows: int      # rows of the block a unit holds
    groups: int    # row groups of the block
    cols: int      # columns of x a unit holds
    ctiles: int    # column tiles of x
    units: int     # ctiles * slices * groups
    grid: int      # CTAs, one an SM at most
    per_cta: int   # most units a CTA owns
    xbufs: int     # x tiles in shared memory: per_cta (resident) or 1
    stages: int    # panel stages of the ring
    pitch: int     # bytes of a staged panel row
    smem: int      # dynamic shared memory of a CTA, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(v: int) -> int:
    return (v + 3) & ~3


def plan(n: int, block: int, k: int, itemsize: int, sms: int,
         capacity: int) -> Plan:
    """The layout the kernel takes on a card with ``sms`` SMs and
    ``capacity`` bytes of opt-in shared memory a CTA.

    A copy of the source's ``make_plan``, which the launcher does not call
    (the C entry makes its own plan): it lets the CPU tests hold the layout
    to brute force, and ``chip_smoke.py`` holds it equal to the source's
    (``c_plan``) on the card.  Units are (column tile, slice, row group);
    CTA c owns units c, c + grid, ...  The CTA keeps one x tile a unit
    when they fit beside two stages, else one it reloads at each step; the
    rest is stages, at most ``MAX_STAGES``."""
    slices = _cdiv(n, SLICE)
    rows = min(_round4(block), ROWS)
    groups = _cdiv(block, rows)
    cols = min(k, MAX_COLS)
    ctiles = _cdiv(k, cols)
    units = ctiles * slices * groups
    grid = min(units, sms)
    per_cta = _cdiv(units, grid)
    pitch = SLICE * itemsize + 16
    stage = rows * pitch
    xtile = SLICE * _round4(cols) * 4
    xbufs = (per_cta if BAR_BYTES + per_cta * xtile + 2 * stage <= capacity
             else 1)
    left = capacity - BAR_BYTES - xbufs * xtile
    stages = max(0, min(MAX_STAGES, left // stage))
    return Plan(slices, rows, groups, cols, ctiles, units, grid, per_cta,
                xbufs, stages, pitch,
                BAR_BYTES + xbufs * xtile + stages * stage)


def scratch_floats(n: int, block: int, k: int) -> int:
    """Floats of the scratch: the counters, then ``DEPTH`` steps of parts
    (slices, block, k)."""
    return HEADER + DEPTH * _cdiv(n, SLICE) * block * k


def c_plan(n: int, block: int, k: int, itemsize: int, sms: int,
           capacity: int) -> Plan:
    """The plan the C source makes for a card with ``sms`` SMs and
    ``capacity`` bytes of opt-in shared memory a CTA, to hold ``plan`` to
    it."""
    fn = _build.library("block_gs").block_gs_plan
    fn.argtypes = [_I] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 12)()
    fn(n, block, k, itemsize, sms, capacity, out)
    return Plan(*out)


def _c_scratch_floats(n: int, block: int, k: int) -> int:
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
    part = torch.empty(_c_scratch_floats(n, block, k), dtype=torch.float32,
                       device=x.device)
    part[:HEADER].zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _build.c_entry("block_gs", "block_gs_sweep", A.dtype, None, _ARGS)
    err = fn(A.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(),
             blocks.data_ptr(), blocks.numel(), int(limit), n, block, k,
             float(beta), stream)
    _build.check_launch(err, "block_gs_sweep")
    LAUNCHES["block_gs_sweep"] += 1
    return out
