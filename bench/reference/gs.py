"""The plain reference: randomized (block) Gauss-Seidel on plain CSR arrays,
in float64, with nothing of the program.

A pick ``p`` of block size ``B`` updates the rows ``p*B .. p*B + B - 1``:
every row's ``gamma = b_r - <A_r, x>`` is taken from x before the pick
writes any of them, then ``x_r += beta * gamma`` (the paper's update for a
unit diagonal; ``B = 1`` is coordinate GS).

``sweep`` replays a pick stream exactly, in groups: a group is a run of
consecutive picks none of which reads a row that an earlier pick of the
same group writes.  Every pick of a group then reads what it would read in
the stream's order, so the group's updates can be taken together from the
x at the group's start; a later pick's write of a row that an earlier pick
read comes after that read in both orders.  A row reads its own diagonal,
so a pick repeated within a run always starts a new group.
``sweep_loop`` is the same update one pick at a time, for the tests.
"""
from __future__ import annotations

import torch

F64 = torch.float64
ROWS_PER_BLOCK = 4096          # rows a residual takes at a time


class Matrix:
    """A square CSR matrix as per-row windows: ``vals`` (n, cap) float64 and
    ``cols`` (n, cap) int64, padding past each row's count with value 0 at
    column 0, and ``valid`` marking the stored slots."""

    def __init__(self, indptr, indices, data):
        n = indptr.numel() - 1
        dev = indptr.device
        counts = indptr[1:] - indptr[:-1]
        cap = max(int(counts.max()), 1)
        slot = torch.arange(cap, device=dev)
        self.valid = slot[None, :] < counts[:, None]
        at = (indptr[:-1, None] + slot[None, :]).clamp(max=max(indices.numel() - 1, 0))
        self.vals = torch.where(self.valid, data[at].to(F64), 0.0)
        self.cols = torch.where(self.valid, indices[at].long(), 0)
        self.n = n

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Per column ``||b - A x||_2`` in float64, (k,)."""
        total = torch.zeros(x.shape[1], dtype=F64, device=x.device)
        x = x.to(F64)
        for lo in range(0, self.n, ROWS_PER_BLOCK):
            hi = min(lo + ROWS_PER_BLOCK, self.n)
            ax = (self.vals[lo:hi, :, None] * x[self.cols[lo:hi]]).sum(1)
            r = b[lo:hi].to(F64) - ax
            total += (r * r).sum(0)
        return total.sqrt()


def _rows(ids: torch.Tensor, block: int) -> torch.Tensor:
    if block == 1:
        return ids
    return (ids[:, None] * block
            + torch.arange(block, device=ids.device)[None, :]).reshape(-1)


def group_starts(A: Matrix, picks: torch.Tensor, block: int) -> list[int]:
    """Where each group of ``picks`` starts (see the module's note).  For
    every pick, the latest earlier pick whose rows it reads is found by a
    search over the stream sorted by (pick, position); a group ends before
    the first pick whose latest such pick lies inside it."""
    L = picks.numel()
    if L == 0:
        return []
    dev = picks.device
    pos = torch.arange(L, device=dev)
    ids = picks.long()
    keys, _ = torch.sort(ids * L + pos)
    reads = torch.where(A.valid[_rows(ids, block)],
                        A.cols[_rows(ids, block)] // block, -1).reshape(L, -1)
    query = reads * L + pos[:, None]
    at = torch.searchsorted(keys, query) - 1
    hit = (reads >= 0) & (at >= 0)
    found = keys[at.clamp(min=0)]
    hit &= found // L == reads
    latest = torch.where(hit, found % L, -1).max(1).values.tolist()
    starts, start = [0], 0
    for p in range(1, L):
        if latest[p] >= start:
            starts.append(p)
            start = p
    return starts


def sweep(A: Matrix, b, x, picks, *, block: int = 1, beta: float = 1.0):
    """``x`` (float64, (n, k)) after the picks, replayed group by group."""
    x = x.to(F64).clone()
    b = b.to(F64)
    starts = group_starts(A, picks, block)
    ends = starts[1:] + [picks.numel()]
    ids = picks.long()
    for lo, hi in zip(starts, ends):
        rows = _rows(ids[lo:hi], block)
        gamma = b[rows] - (A.vals[rows, :, None] * x[A.cols[rows]]).sum(1)
        x[rows] = x[rows] + beta * gamma
    return x


def sweep_loop(A: Matrix, b, x, picks, *, block: int = 1, beta: float = 1.0):
    """``sweep`` one pick at a time, in the stream's order."""
    x = x.to(F64).clone()
    b = b.to(F64)
    for p in picks.tolist():
        rows = torch.arange(p * block, (p + 1) * block, device=x.device)
        gamma = b[rows] - (A.vals[rows, :, None] * x[A.cols[rows]]).sum(1)
        x[rows] = x[rows] + beta * gamma
    return x
