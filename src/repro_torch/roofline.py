"""Roofline bounds of the port's kernels on one card (the counterpart of
``repro/roofline.py``).

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output
written once) over the card's memory rate, and the operations it does over
the card's peak rate for their type::

    bound_ms = max(bytes / HBM rate, f32 flops / f32 rate)

The reference reads FLOPs and bytes from an XLA module's
``compiled.cost_analysis()`` and prices them at TPU v5e peaks.  The port
compiles no XLA module, so each kernel's work is counted here from its
shapes, its dtypes and the operator's stored counts, never from the code
that implements it: whatever kernel computes a function, its bound reads
the same work.  Where the work depends on the data (the picked rows'
nonzeros, the picks a rank owns), the caller counts what its run's data
needs.  Value and index bytes come from the storage dtypes; the iterate,
``b``, the products and the records are f32 and the ids, counts and row
starts int32 whatever the storage.

``ring_wire_bytes`` keeps the reference's ring model of a collective's
wire bytes, without the HLO parsing and without a link bandwidth: on one
card the ranks exchange through gloo and host memory, not NVLink, so a
collective's time in seconds would be a number the card never shows.

``sweep_roofline`` prices one sweep of the main path (n picks and one
record), the counterpart of ``Roofline.roofline_fraction``.

No counterpart: ``analyze(cost, hlo_text)`` and ``shape_bytes`` read XLA
artifacts (cost analysis, HLO text), and ``model_flops_train``/
``model_flops_decode`` (6ND, 2ND) count a model's parameters; the solver
has neither.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = [
    "PEAKS",
    "Peaks",
    "SweepRoofline",
    "Work",
    "banded_gs_sweep",
    "banded_rk_sweep",
    "bbmv",
    "block_gs_sweep",
    "bound_ms",
    "colsum",
    "peaks",
    "ring_wire_bytes",
    "spmv_csr",
    "spmv_csr_prefetch",
    "spmv_csr_sliced",
    "spmv_csr_sliced_prefetch",
    "spmv_ell",
    "sweep_roofline",
    "sweep_rows_block_gs",
    "sweep_rows_gs",
    "sweep_rows_rk",
    "sweep_rows_rk_delta",
    "sweep_rows_rk_delta_window",
]


@dataclass(frozen=True)
class Peaks:
    """A card's published peak rates."""

    hbm_bytes_per_s: float
    f32_flops_per_s: float


#: Published peaks by ``torch.cuda.get_device_name()``: one H100 SXM at its
#: full 700 W power limit (NVIDIA's data sheet), HBM3 bandwidth and the f32
#: rate outside the tensor cores.  A card set below 700 W runs slower than
#: these under load; its power limit belongs beside every share of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(hbm_bytes_per_s=3.35e12,
                                   f32_flops_per_s=67e12),
}

F32 = 4         # bytes of the iterate, b, products, records, row norms
INDEX = 4       # bytes of a pick id, a row count or start, a gate


def peaks(device_name: str) -> Peaks:
    """The peaks of the card named ``device_name``; a card without
    published peaks in ``PEAKS`` raises (no other card's are reused)."""
    try:
        return PEAKS[device_name]
    except KeyError:
        raise ValueError(f"no published peaks for {device_name!r} (known: "
                         f"{sorted(PEAKS)})") from None


@dataclass(frozen=True)
class Work:
    """The bytes a function must move and the f32 operations it does."""

    bytes: float
    flops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def __mul__(self, times: float) -> "Work":
        return Work(self.bytes * times, self.flops * times)

    __rmul__ = __mul__


def bound_ms(work: Work, device_name: str) -> tuple[float, str]:
    """(the least milliseconds the card takes for ``work``, what bounds
    it: "bytes" or "operations")."""
    p = peaks(device_name)
    t_bytes = work.bytes / p.hbm_bytes_per_s * 1e3
    t_ops = work.flops / p.f32_flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _entry(value_dtype: torch.dtype, index_dtype: torch.dtype) -> int:
    """Bytes of one stored nonzero: its value and its column index."""
    return value_dtype.itemsize + index_dtype.itemsize


# ---------------------------------------------------------------------------
# The row sweeps (kernels/sweep_csr.py): a serial chain of picks.  Per pick
# its row's stored nonzeros (value and index), its b row and its id (and
# the Kaczmarz divisor rn); the carries once in and once out.
# ---------------------------------------------------------------------------

def _row_sweep(picked_nnz, picks, n, k, value_dtype, index_dtype, *,
               carries: int, divisor: bool, flops_per_entry: int) -> Work:
    per_pick = k * F32 + INDEX + (F32 if divisor else 0)
    return Work(picked_nnz * _entry(value_dtype, index_dtype)
                + picks * per_pick + 2 * carries * n * k * F32,
                flops_per_entry * picked_nnz * k + 3.0 * k * picks)


def sweep_rows_gs(picked_nnz, picks, n, k, *, value_dtype=torch.float32,
                  index_dtype=torch.int32) -> Work:
    """Coordinate GS over ``picks`` rows holding ``picked_nnz`` stored
    nonzeros in all, on an (n, k) iterate: per nonzero 2 flops a column
    (the row dot), per pick 3 a column (residual, scale, update)."""
    return _row_sweep(picked_nnz, picks, n, k, value_dtype, index_dtype,
                      carries=1, divisor=False, flops_per_entry=2)


def sweep_rows_rk(picked_nnz, picks, n, k, *, value_dtype=torch.float32,
                  index_dtype=torch.int32) -> Work:
    """Kaczmarz over ``picks`` rows (``picked_nnz`` stored nonzeros) on an
    (n, k) iterate of n columns: per nonzero 5 flops a column (the dot, and
    the scaled row added to x), per pick 3 a column; rn read a pick."""
    return _row_sweep(picked_nnz, picks, n, k, value_dtype, index_dtype,
                      carries=1, divisor=True, flops_per_entry=5)


def sweep_rows_rk_delta(picked_nnz, picks, n, k, *,
                        value_dtype=torch.float32,
                        index_dtype=torch.int32) -> Work:
    """``sweep_rows_rk`` on two carries, x and the round's delta d: both
    once in and once out, and one more add a nonzero and column."""
    return _row_sweep(picked_nnz, picks, n, k, value_dtype, index_dtype,
                      carries=2, divisor=True, flops_per_entry=6)


def sweep_rows_rk_delta_window(picks, n, k, *, value_dtype=torch.float32,
                               index_dtype=torch.int32) -> Work:
    """``sweep_rows_rk_delta`` over dense windows of width n (``dense_rk``'s
    local phase): every pick's row stores all n columns."""
    return sweep_rows_rk_delta(picks * n, picks, n, k,
                               value_dtype=value_dtype,
                               index_dtype=index_dtype)


def sweep_rows_block_gs(picked_nnz, rows, picks, n, k, *,
                        value_dtype=torch.float32,
                        index_dtype=torch.int32) -> Work:
    """Block GS on CSR: ``picks`` panels of ``rows`` rows in all, holding
    ``picked_nnz`` stored nonzeros; per row its b row and 3 flops a
    column, per pick its id, x once in and once out."""
    return Work(picked_nnz * _entry(value_dtype, index_dtype)
                + rows * k * F32 + picks * INDEX + 2 * n * k * F32,
                2.0 * picked_nnz * k + 3.0 * k * rows)


# ---------------------------------------------------------------------------
# The matvecs: each stored nonzero (value and index), x (n, k) once, y
# (m, k) once; 2 flops a nonzero and column.
# ---------------------------------------------------------------------------

def _matvec(entries, m, n, k, value_dtype, index_dtype) -> Work:
    return Work(entries * _entry(value_dtype, index_dtype)
                + n * k * F32 + m * k * F32, 2.0 * entries * k)


def spmv_csr_sliced(nnz, m, n, k, *, counts: bool,
                    value_dtype=torch.float32,
                    index_dtype=torch.int32) -> Work:
    """A·x from the sliced-ELL view of an (m, n) CSR operator; padding
    slots carry nothing, and ``counts`` adds each row's stored count (read
    where the operator stops its rows)."""
    return (_matvec(nnz, m, n, k, value_dtype, index_dtype)
            + Work(m * INDEX if counts else 0, 0))


def spmv_csr_sliced_prefetch(nnz, m, n, k, panels, *, counts: bool,
                             value_dtype=torch.float32,
                             index_dtype=torch.int32) -> Work:
    """``spmv_csr_sliced`` that also reads each panel's nonzero count."""
    return (spmv_csr_sliced(nnz, m, n, k, counts=counts,
                            value_dtype=value_dtype, index_dtype=index_dtype)
            + Work(panels * INDEX, 0))


def spmv_csr(nnz, m, n, k, *, value_dtype=torch.float32,
             index_dtype=torch.int32) -> Work:
    """The segment sum over the flat CSR layout: each row's start and
    count (it reads no row id)."""
    return (_matvec(nnz, m, n, k, value_dtype, index_dtype)
            + Work(m * 2 * INDEX, 0))


def spmv_csr_prefetch(nnz, m, n, k, panels, *, value_dtype=torch.float32,
                      index_dtype=torch.int32) -> Work:
    """``spmv_csr`` that also reads each panel's nonzero count."""
    return (spmv_csr(nnz, m, n, k, value_dtype=value_dtype,
                     index_dtype=index_dtype) + Work(panels * INDEX, 0))


def spmv_ell(stored, m, n, k, *, counts: bool, value_dtype=torch.float32,
             index_dtype=torch.int32) -> Work:
    """ELL A·x over ``stored`` entries before the rows' padding (the
    padding carries nothing), with the rows' counts where given."""
    return (_matvec(stored, m, n, k, value_dtype, index_dtype)
            + Work(m * INDEX if counts else 0, 0))


# ---------------------------------------------------------------------------
# The block-banded and dense kernels: whole tiles and row panels.
# ---------------------------------------------------------------------------

def bbmv(tiles, block, n, k, *, value_dtype=torch.float32) -> Work:
    """Block-banded A·x over the ``tiles`` tiles of block² entries inside
    the matrix (the kernel reads no other), x and y of n rows once."""
    return Work(tiles * block * block * value_dtype.itemsize + 2 * n * k * F32,
                2.0 * tiles * block * block * k)


def banded_gs_sweep(picks, block, bands, window_rows, k, *,
                    value_dtype=torch.float32) -> Work:
    """The banded GS chain: per pick its 2·bands + 1 tiles, its b block and
    its id; the window of x once in and once out."""
    tiles = 2 * bands + 1
    per_pick = tiles * block * block * value_dtype.itemsize + block * k * F32 \
        + INDEX
    return Work(picks * per_pick + 2 * window_rows * k * F32,
                2.0 * picks * tiles * block * block * k)


def banded_rk_sweep(owned, block, bands, window_rows, k, *,
                    value_dtype=torch.float32) -> Work:
    """The banded Kaczmarz chain on two carries: a pick whose gate is 0
    leaves both windows as they were, so only the ``owned`` picks count:
    each its tiles, b block, row norms, id and gate, and 4 flops an entry
    and column (A x, then Aᵀ g); both windows once in and once out."""
    tiles = 2 * bands + 1
    per_pick = (tiles * block * block * value_dtype.itemsize + block * k * F32
                + block * F32 + 2 * INDEX)
    return Work(owned * per_pick + 2 * 2 * window_rows * k * F32,
                4.0 * owned * tiles * block * block * k)


def block_gs_sweep(picks, block, n, k, *, value_dtype=torch.float32) -> Work:
    """Dense block GS: per pick its (block, n) row panel, its b block and
    its id, 2·block·n flops a column for the panel product and 3·block for
    the update; x once in and once out."""
    per_pick = block * n * value_dtype.itemsize + block * k * F32 + INDEX
    return Work(picks * per_pick + 2 * n * k * F32,
                picks * (2.0 * block * n * k + 3.0 * block * k))


def colsum(n, k) -> Work:
    """The records' column sums of an (n, k) f32 tensor: it once, the k
    sums once, an add an element."""
    return Work(n * k * F32 + k * F32, float(n * k))


# ---------------------------------------------------------------------------
# Collectives and the main path's sweep
# ---------------------------------------------------------------------------

#: the collectives of the reference's ring model
RING_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
              "collective-permute")


def ring_wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Wire bytes a member of a ``group``-rank ring sends for one
    collective whose output holds ``out_bytes``: the reference's model
    (``collective_bytes``), without the HLO parsing.  A group of one sends
    nothing, but a collective-permute sends its buffer."""
    if kind not in RING_KINDS:
        raise ValueError(f"unknown collective {kind!r} (choose from "
                         f"{RING_KINDS})")
    if kind == "collective-permute":
        return float(out_bytes)
    if group <= 1:
        return 0.0
    if kind == "reduce-scatter":
        return float(out_bytes * (group - 1))
    if kind == "all-reduce":
        return 2.0 * out_bytes * (group - 1) / group
    return out_bytes * (group - 1) / group        # all-gather, all-to-all


@dataclass(frozen=True)
class SweepRoofline:
    """The bound of one sweep of the main path and the work behind it."""

    sweep: Work
    record: Work
    ms: float
    bound_by: str

    def share(self, measured_ms: float) -> float:
        """The bound's share of a measured sweep (1 at the roof)."""
        return self.ms / measured_ms


def sweep_roofline(action: str, *, picked_nnz, picks, nnz, m, n, k,
                   counts: bool, device_name: str,
                   value_dtype=torch.float32,
                   index_dtype=torch.int32) -> SweepRoofline:
    """The bound of one sweep of the main path on an (m, n) CSR operator of
    ``nnz`` stored nonzeros: ``picks`` picks of the row sweep (GS or
    Kaczmarz, holding ``picked_nnz`` nonzeros) and one record
    (``core/engine.py::record_metrics``).  A GS record is two matvecs and
    two ``colsum`` of (m, k) (the A-norm error and the residual); a
    Kaczmarz record one matvec and the ``colsum`` of the error (n, k) and
    of the residual (m, k).  The matvec is the sliced kernel, with the
    rows' counts where ``counts``.  The record's elementwise products are
    not counted.

    This is a byte bound of a serial chain: a pick reads the x its
    predecessor wrote, so the chain's latency, not the card's memory
    rate, limits such a kernel (the chain floor that
    ``tune/csr_block_gs_probe.py --floor`` measures for the block sweep;
    ``PERF.md`` §6)."""
    dt = dict(value_dtype=value_dtype, index_dtype=index_dtype)
    matvec = spmv_csr_sliced(nnz, m, n, k, counts=counts, **dt)
    if action == "gs":
        sweep = sweep_rows_gs(picked_nnz, picks, n, k, **dt)
        record = 2 * matvec + 2 * colsum(m, k)
    elif action == "rk":
        sweep = sweep_rows_rk(picked_nnz, picks, n, k, **dt)
        record = matvec + colsum(n, k) + colsum(m, k)
    else:
        raise ValueError(f"unknown action: {action!r}")
    ms, by = bound_ms(sweep + record, device_name)
    return SweepRoofline(sweep=sweep, record=record, ms=ms, bound_by=by)
