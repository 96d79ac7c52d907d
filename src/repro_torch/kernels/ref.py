"""Plain PyTorch versions of the port's kernels.

These are the CPU path of every kernel wrapper (``kernels/ops.py``) and the
versions ``chip_smoke.py`` holds each CUDA kernel against on the card.
Every product and sum accumulates in f32: bf16 values are widened with
``.float()`` and int16 column ids with ``.long()`` before any gather.

Row windows are contracted one slot at a time, in slot order, and band
tiles one tile column at a time, in column order, so a result never
depends on how many RHS columns ride along: a zero-padded column leaves
every other column bitwise unchanged.
"""
from __future__ import annotations

import torch


def spmv_csr_ref(data, indices, row_id, x, *, m: int):
    """``y = A @ x`` from flat CSR triples by a segment sum (``index_add_``).

    Padding slots carry ``data == 0`` (and point at column 0 / row 0), so
    they add exact zeros wherever they land.
    """
    contrib = data.float()[:, None] * x[indices.long()]
    y = torch.zeros((m, x.shape[1]), dtype=torch.float32, device=x.device)
    return y.index_add_(0, row_id.long(), contrib).to(x.dtype)


def spmv_csr_segsum_ref(data, indices, row_id, x, *, m: int,
                        rows_per_panel: int, panel_width: int):
    """``y = A @ x`` by a segment sum over the panels' slots of the flat
    layout (the first ``num_panels * panel_width`` slots; the row-window
    slack after the last panel is not read), as the legacy kernels read
    it."""
    body = -(-m // rows_per_panel) * panel_width
    return spmv_csr_ref(data[:body], indices[:body], row_id[:body], x, m=m)


def spmv_csr_segsum_prefetch_ref(data, indices, row_id, panel_nnz, x, *,
                                 m: int, rows_per_panel: int,
                                 panel_width: int):
    """``spmv_csr_segsum_ref`` with the rows of empty panels written as
    zeros; bitwise equal to it for finite ``x``."""
    y = spmv_csr_segsum_ref(data, indices, row_id, x, m=m,
                            rows_per_panel=rows_per_panel,
                            panel_width=panel_width)
    keep = (panel_nnz > 0).repeat_interleave(rows_per_panel)[:m]
    return torch.where(keep[:, None], y, torch.zeros_like(y))


def window_dot(vals, cols, x):
    """Contract row windows ``vals``/``cols`` of shape (..., width) with
    the gathered rows of ``x`` (n, k), slot by slot in slot order: one
    window (width,) gives ``<A_r, x>`` per RHS column."""
    prod = vals.float()[..., None] * x[cols.long()]      # (..., width, k)
    acc = torch.zeros(prod.shape[:-2] + prod.shape[-1:], dtype=torch.float32,
                      device=x.device)
    for w in range(prod.shape[-2]):
        acc = acc + prod[..., w, :]
    return acc


def spmv_csr_sliced_ref(vals, cols, x, *, m: int):
    """``y = A @ x`` from the sliced-ELL view: each output row contracts
    its own window in slot order."""
    return window_dot(vals[:m], cols[:m], x)


def spmv_csr_sliced_prefetch_ref(vals, cols, panel_nnz, x, *, m: int,
                                 rows_per_panel: int):
    """``spmv_csr_sliced_ref`` with the rows of empty panels written as
    zeros; bitwise equal to it for finite ``x``."""
    y = spmv_csr_sliced_ref(vals, cols, x, m=m)
    keep = (panel_nnz > 0).repeat_interleave(rows_per_panel)[:m]
    return torch.where(keep[:, None], y, torch.zeros_like(y))


def block_gs_sweep_ref(A, b, x, blocks, *, block: int, beta: float = 1.0):
    """``len(blocks)`` sequential dense block-GS steps; returns a new x.

    Step ``bi``: ``g = b[B] - A[B, :] @ x`` with ``B`` the rows
    ``[bi * block, (bi + 1) * block)`` (A widened to f32 first), then
    ``x[B] += beta * g``.  The panel product is taken one column of x at a
    time (a contiguous matrix-vector product each), so a column's result
    does not depend on how many columns ride along.
    """
    x = x.clone()
    if x.shape[1] == 0:
        return x
    for bi in blocks.tolist():
        rows = slice(bi * block, (bi + 1) * block)
        panel = A[rows].float()
        prod = torch.stack([panel @ x[:, c].contiguous()
                            for c in range(x.shape[1])], 1)
        x[rows] += beta * (b[rows] - prod)
    return x


def spmv_ell_ref(vals, cols, x):
    """``y = A @ x`` from ELL windows (n, width): each row contracts its
    window in slot order."""
    return window_dot(vals, cols, x)


def tile_dot(tiles, xs):
    """``tiles @ xs`` for (..., bl, bl) tiles and (..., bl, k) blocks of x,
    summed over the tile's columns j in order from 0, in f32."""
    t = tiles.float()
    acc = torch.zeros(t.shape[:-1] + xs.shape[-1:], dtype=torch.float32,
                      device=xs.device)
    for j in range(t.shape[-1]):
        acc = acc + t[..., :, j, None] * xs[..., j, None, :]
    return acc


def band_valid(nb: int, bands: int, device) -> torch.Tensor:
    """(nb, 2*bands+1) bool: whether band d of block row i has a block
    column ``i + d - bands`` inside [0, nb)."""
    j = (torch.arange(nb, device=device)[:, None]
         + torch.arange(-bands, bands + 1, device=device)[None, :])
    return (j >= 0) & (j < nb)


def bbmv_ref(A_bands, x, *, bands: int, block: int):
    """``y = A @ x`` for block-banded tiles ``A_bands`` (nb, 2*bands+1,
    block, block): ``y_i = sum_d A_bands[i, d] @ x[block i + d - bands]``,
    band by band in order, bands whose block column lies outside the
    matrix masked out."""
    nb, width = A_bands.shape[:2]
    k = x.shape[1]
    xb = x.reshape(nb, block, k)
    valid = band_valid(nb, bands, x.device)
    rows = torch.arange(nb, device=x.device)
    acc = torch.zeros((nb, block, k), dtype=torch.float32, device=x.device)
    for d in range(width):
        part = tile_dot(A_bands[:, d], xb[(rows + d - bands).clamp(0, nb - 1)])
        acc = acc + torch.where(valid[:, d, None, None], part, 0.0)
    return acc.reshape(nb * block, k)


def gs_step(vals, cols, b, x, r: int, *, beta: float, write_base: int = 0):
    """One coordinate-GS step on ``x`` in place:
    ``x[base + r] += beta * (b[r] - <A_r, x>)``."""
    gamma = b[r] - window_dot(vals[r], cols[r], x)
    x[write_base + r] += beta * gamma


def rk_contrib(vals_r, g, beta: float):
    """Kaczmarz row action's contribution ``(beta * vals_r) * g`` per slot
    (width, k); slots with value 0 (the padding) contribute exact zeros,
    as the CUDA kernel skips them."""
    v = vals_r.float()
    upd = (beta * v)[:, None] * g[None, :]
    return upd.masked_fill((v == 0)[:, None], 0.0)


def rk_step(vals, cols, b, rn, x, r: int, *, beta: float, d=None):
    """One Kaczmarz step on ``x`` in place:
    ``g = (b[r] - <A_r, x>) / rn[r]``, then ``x[cols_r] += rk_contrib``.
    With a delta carry ``d``, the same contribution is added to it too."""
    g = (b[r] - window_dot(vals[r], cols[r], x)) / rn[r]
    upd = rk_contrib(vals[r], g, beta)
    for carry in (x,) if d is None else (x, d):
        carry.index_add_(0, cols[r].long(), upd)


def sweep_rows_gs_ref(vals, cols, b, x, picks, *, beta: float = 1.0,
                      write_base: int = 0):
    """``len(picks)`` sequential coordinate-GS steps; returns a new x."""
    x = x.clone()
    for r in picks.tolist():
        gs_step(vals, cols, b, x, r, beta=beta, write_base=write_base)
    return x


def sweep_rows_block_gs_ref(vals, cols, b, x, blocks, *, block: int,
                            beta: float = 1.0):
    """``len(blocks)`` sequential block-GS steps over row windows; returns a
    new x.  Step ``bi`` takes every row's ``gamma = b[r] - <A_r, x>`` of
    ``B = [bi * block, (bi + 1) * block)`` (``gs_step``'s arithmetic, each
    row's window in slot order), then ``x[B] += beta * gamma``; at
    ``block = 1`` it is bitwise ``sweep_rows_gs_ref``."""
    x = x.clone()
    for bi in blocks.tolist():
        rows = slice(bi * block, (bi + 1) * block)
        gamma = b[rows] - window_dot(vals[rows], cols[rows], x)
        x[rows] += beta * gamma
    return x


def sweep_rows_rk_ref(vals, cols, b, rn, x, picks, *, beta: float = 1.0):
    """``len(picks)`` sequential Kaczmarz steps; returns a new x."""
    x = x.clone()
    for r in picks.tolist():
        rk_step(vals, cols, b, rn, x, r, beta=beta)
    return x


def sweep_rows_rk_delta_ref(vals, cols, b, rn, x, d, picks, *,
                            beta: float = 1.0):
    """``len(picks)`` sequential Kaczmarz steps on the replica ``x`` (read
    and written) and the round delta ``d`` (written only), each step's
    contribution added to both; returns new ``(x, d)``."""
    x, d = x.clone(), d.clone()
    for r in picks.tolist():
        rk_step(vals, cols, b, rn, x, r, beta=beta, d=d)
    return x, d


def colsum_ref(t):
    """Column sums of an (n, k) tensor, each column reduced on its own
    contiguous copy (so a column's sum does not depend on k)."""
    return t.T.contiguous().sum(1)
