"""Norm-balanced slab assignment for the distributed engine (port of
``repro/core/partition.py``).

The periodic-synchronization schedule cuts the rows into P contiguous
slabs.  Sparse Kaczmarz samples each rank's rows ∝ its slab's row norms,
so the interleaved stream follows the global law ``P(i) ∝ ||A_i||²``
only when every slab carries the same norm mass; and a round lasts as
long as its slowest rank, so nnz-skewed slabs stretch it.

This module bin-packs the rows by ``row_norms_sq`` (then by nonzero
count) into P bins of m/P rows, and realizes the assignment as a row
permutation applied to the operator once, up front: downstream every
slab is contiguous again.  For the row action ("rk") the permutation
moves rows only; for the coordinate action ("gs", square SPD) it is
symmetric (``P A Pᵀ``), and the engine un-permutes the returned iterate.

The bin-packing is a greedy loop over the rows in numpy, run once per
solve on the host: the row norms and nonzero counts are read back in one
read.  The permuted operator is built on its own device (``CsrOp`` through
``CsrOp._assemble``, ``EllOp`` by indexing its windows).  The reference's
``shard_spec`` (a ``shard_map`` ``PartitionSpec``) has no counterpart: a
rank takes its slab by slicing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.operators import CsrOp, EllOp

__all__ = [
    "RowPermutation",
    "apply_partition",
    "balanced_labels",
    "balanced_row_permutation",
    "cross_slab_edges",
    "norm_balanced_assignment",
    "partition_permutation",
    "permute_rows",
    "slab_norm_mass",
]

_PADDED_ROWS = ("balanced partitioning needs a padded-row format "
                "(CsrOp/EllOp); got {} — contiguous slabs are the only "
                "assignment the dense/banded layouts support")


class RowPermutation(NamedTuple):
    """A slab assignment realized as a row permutation: ``perm[i]`` is the
    original row placed at position ``i`` (slab ``w`` owns positions
    ``[w*m/P, (w+1)*m/P)``), ``inv`` its inverse (``inv[perm[i]] == i``).
    Both int64 on the operator's device."""
    perm: torch.Tensor
    inv: torch.Tensor


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def norm_balanced_assignment(row_norms_sq, row_nnz,
                             num_slabs: int) -> np.ndarray:
    """Greedy LPT bin-packing of rows into ``num_slabs`` equal-size bins.

    Rows are taken in decreasing ``row_norms_sq`` order; each goes to the
    non-full bin with the least norm mass so far, ties broken by the least
    nonzero count, then the lowest bin index.  Equal bin sizes (m/P rows)
    are a hard constraint.  Returns the per-row bin labels, shape (m,).
    """
    rn = _host(row_norms_sq).astype(np.float64).reshape(-1)
    nz = _host(row_nnz).astype(np.float64).reshape(-1)
    m = rn.size
    if m % num_slabs:
        raise ValueError(
            f"slab count ({num_slabs}) must divide the row count ({m})")
    cap = m // num_slabs
    order = np.argsort(-rn, kind="stable")
    labels = np.empty((m,), np.int32)
    mass = np.zeros((num_slabs,), np.float64)
    work = np.zeros((num_slabs,), np.float64)
    fill = np.zeros((num_slabs,), np.int64)
    for r in order:
        cand = np.flatnonzero(fill < cap)
        best = cand[np.lexsort((cand, work[cand], mass[cand]))[0]]
        labels[r] = best
        mass[best] += rn[r]
        work[best] += nz[r]
        fill[best] += 1
    return labels


def partition_permutation(labels, num_slabs: int, *,
                          device=None) -> RowPermutation:
    """The permutation placing each bin's rows (in ascending original
    order) at its contiguous slab positions, on ``device`` (default the
    CPU)."""
    labels = _host(labels).reshape(-1)
    perm = np.concatenate(
        [np.flatnonzero(labels == w) for w in range(num_slabs)])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return RowPermutation(
        perm=torch.as_tensor(perm, dtype=torch.int64, device=device),
        inv=torch.as_tensor(inv, dtype=torch.int64, device=device))


def balanced_labels(op, num_slabs: int) -> np.ndarray:
    """Per-row slab labels of the norm/nnz-balanced assignment of a
    padded-row operator; the row norms and the nonzero counts come back
    from the device in one read."""
    if not hasattr(op, "padded_rows"):
        raise NotImplementedError(_PADDED_ROWS.format(type(op).__name__))
    vals, _ = op.padded_rows()
    m = op.shape[0]
    both = torch.stack([op.row_norms_sq().double(),
                        (vals[:m] != 0).sum(1).double()]).cpu().numpy()
    return norm_balanced_assignment(both[0], both[1], num_slabs)


def balanced_row_permutation(op, num_slabs: int) -> RowPermutation:
    """The norm/nnz-balanced ``RowPermutation`` of a padded-row operator,
    on its device."""
    return partition_permutation(balanced_labels(op, num_slabs), num_slabs,
                                 device=op.device)


def cross_slab_edges(op, labels, num_slabs: int, *,
                     col_labels=None) -> int:
    """Count of stored nonzeros reaching outside their owner slab.

    ``labels`` assigns each row to a slab; a nonzero ``(i, j)`` crosses
    when its column's slab differs from its row's.  Columns are owned
    contiguously (``j // (n / P)``, the engine's column-slab ownership)
    unless ``col_labels`` assigns them (a square symmetric assignment)."""
    if not hasattr(op, "padded_rows"):
        raise NotImplementedError(
            "cross_slab_edges needs a padded-row format (CsrOp/EllOp); "
            f"got {type(op).__name__}")
    m, n = op.shape
    if n % num_slabs:
        raise ValueError(
            f"slab count ({num_slabs}) must divide the column count ({n}) "
            "for contiguous column ownership")
    labels = _host(labels).reshape(-1)
    if labels.shape != (m,):
        raise ValueError(f"labels must assign every row: {labels.shape} "
                         f"vs m={m}")
    vals, cols = (_host(a)[:m] for a in op.padded_rows())
    cols = cols.astype(np.int64)
    if col_labels is None:
        col_lab = cols // (n // num_slabs)
    else:
        col_lab = _host(col_labels).reshape(-1)[cols]
    real = vals != 0
    return int((real & (labels[:, None] != col_lab)).sum())


def slab_norm_mass(row_norms_sq, perm, num_slabs: int) -> np.ndarray:
    """Per-slab Σ ||A_i||² under ``perm`` (uniform: total / P each)."""
    rn = _host(row_norms_sq).astype(np.float64).reshape(-1)[_host(perm)]
    return rn.reshape(num_slabs, -1).sum(axis=1)


def permute_rows(op, rp: RowPermutation, *, symmetric: bool = False):
    """``rp`` applied to an operator, in the same format.

    ``symmetric=False`` permutes the rows only (``P A``); ``symmetric=True``
    applies ``P A Pᵀ``, the column ids relabeled through ``inv``.  A
    ``CsrOp`` is re-packed by ``CsrOp._assemble`` into the contiguous panel
    layout; an ``EllOp`` permutes its windows.  Padding slots hold value 0,
    so relabeling their column ids adds nothing.
    """
    if symmetric and op.shape[0] != op.shape[1]:
        raise ValueError(
            f"symmetric permutation needs a square operator; got {op.shape}")
    if isinstance(op, EllOp):
        vals, cols = op.vals[rp.perm], op.cols[rp.perm]
        if symmetric:
            cols = rp.inv[cols.long()].to(op.cols.dtype)
        return EllOp(vals, cols)
    if isinstance(op, CsrOp):
        m = op.shape[0]
        vals, cols = (a[:m] for a in op.padded_rows())
        counts = op.row_nnz[rp.perm]
        vals, cols = vals[rp.perm], cols[rp.perm].long()
        if symmetric:
            cols = rp.inv[cols]
        return CsrOp._assemble(vals, cols.to(torch.int32), counts,
                               shape=op.shape,
                               rows_per_panel=op.rows_per_panel)
    raise NotImplementedError(_PADDED_ROWS.format(type(op).__name__))


def apply_partition(op, b, x0, x_star, *, action: str, num_slabs: int):
    """``(op', b', x0', x_star', rp)``: the problem permuted onto balanced
    slabs.  For "rk" the iterate lives in column space and is untouched;
    for "gs" the symmetric permutation moves the coordinate vectors too,
    and the caller un-permutes the result with ``rp.inv``."""
    rp = balanced_row_permutation(op, num_slabs)
    symmetric = action == "gs"
    op2 = permute_rows(op, rp, symmetric=symmetric)
    b2 = b[rp.perm]
    if symmetric:
        x0 = x0[rp.perm]
        x_star = None if x_star is None else x_star[rp.perm]
    return op2, b2, x0, x_star, rp
