"""The paper's sparse SPD problem (Avron, Druinsky and Gupta, arXiv:1304.6475;
the reference package's ``random_sparse_spd``), built as sparse arrays.

``A = I + c (S + S^T) / 2``: each row of S holds ``row_nnz`` standard
normal entries in distinct random columns; the diagonal of ``(S + S^T) /
2`` is dropped and ``c`` is set by Gershgorin so that the largest
off-diagonal absolute row sum is ``offdiag``, which keeps lambda_min >= 1
- offdiag.  The reference package builds the same matrix densely on the
host with numpy's generator; this one draws on ``device`` with a
``torch.Generator`` seeded by the configuration's ``matrix_seed``, in a few
large calls, and never forms the n x n matrix.
"""
from __future__ import annotations

import torch

from bench.problem import Problem

KEYS_PER_DRAW = 1 << 24      # random keys drawn at a time (64 MiB)


def generate(config: dict, device) -> Problem:
    n, r = int(config["n"]), int(config["row_nnz"])
    g = torch.Generator(device=device)
    g.manual_seed(int(config["matrix_seed"]))
    picked = torch.empty((n, r), dtype=torch.int64, device=device)
    step = max(1, KEYS_PER_DRAW // n)
    for lo in range(0, n, step):
        keys = torch.rand((min(step, n - lo), n), generator=g, device=device)
        picked[lo:lo + step] = keys.topk(r, dim=1).indices   # distinct columns
    vals = torch.randn((n, r), generator=g, dtype=torch.float64, device=device)
    rows = torch.arange(n, device=device).repeat_interleave(r)
    cols = picked.reshape(-1)
    i = torch.cat([rows, cols])
    j = torch.cat([cols, rows])
    v = torch.cat([vals.reshape(-1), vals.reshape(-1)]) * 0.5
    off = i != j
    key, inverse = torch.unique(i[off] * n + j[off], return_inverse=True)
    # An entry is the sum of at most two halves (row i picked j, row j
    # picked i), so the order of this sum cannot change its value.
    summed = torch.zeros(key.numel(), dtype=torch.float64, device=device)
    summed.index_add_(0, inverse, v[off])
    row, col = key // n, key % n
    counts = torch.bincount(row, minlength=n)
    # Gershgorin: the largest absolute row sum, each row summed over a
    # fixed-width window so that the result is the same from run to run.
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(key.numel(), device=device) - start[row]
    window = torch.zeros((n, max(int(counts.max()), 1)), dtype=torch.float64,
                         device=device)
    window[row, pos] = summed.abs()
    scale = float(config["offdiag"]) / max(float(window.sum(1).max()), 1e-30)
    diag = torch.arange(n, device=device)
    key_all = torch.cat([key, diag * n + diag])
    val_all = torch.cat([summed * scale, torch.ones(n, dtype=torch.float64,
                                                    device=device)])
    order = torch.argsort(key_all)
    key_all, val_all = key_all[order], val_all[order]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts + 1, 0)
    return Problem(n=n, indptr=indptr, indices=key_all % n,
                   data=val_all.to(torch.float32))
