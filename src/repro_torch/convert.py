"""Problem data from numpy arrays, so the port and the reference compute on
identical inputs.

The reference's SPD ``x_star``/``b`` come from ``jax.random`` and cannot be
reproduced with a ``torch.Generator``; parity tests take them, as numpy,
from the reference problem.  ``csr_from_arrays``, ``ell_from_arrays`` and
``banded_from_arrays`` take the arrays (and layout) of a reference
``CsrOp``/``EllOp``/``BlockBandedOp`` as they are, so a test can also pin
the layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kaczmarz import LSQProblem
from repro_torch.core.operators import BlockBandedOp, CsrOp, EllOp
from repro_torch.core.spd import SPDProblem


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 arrays included) as a tensor on ``device``.
    The array is copied (arrays exported by other frameworks are often
    read-only)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 has no torch twin
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(float(np.asarray(v)), dtype=torch.float32,
                        device=device)


def spd_problem_from_numpy(A, b, x_star, lam_min, lam_max,
                           device) -> SPDProblem:
    return SPDProblem(A=_tensor(A, device), b=_tensor(b, device),
                      x_star=_tensor(x_star, device),
                      lam_min=_scalar(lam_min, device),
                      lam_max=_scalar(lam_max, device))


def lsq_problem_from_numpy(A, b, x_star, x_true, sigma_min, sigma_max,
                           device) -> LSQProblem:
    return LSQProblem(A=_tensor(A, device), b=_tensor(b, device),
                      x_star=_tensor(x_star, device),
                      x_true=_tensor(x_true, device),
                      sigma_min=_scalar(sigma_min, device),
                      sigma_max=_scalar(sigma_max, device))


def csr_from_arrays(data, indices, row_id, row_start, row_nnz, *, shape, nnz,
                    row_cap, rows_per_panel, panel_width, device) -> CsrOp:
    """A ``CsrOp`` from the leaves and layout of a reference ``CsrOp``.

    The kernels gather through these arrays with raw pointers, so the
    layout is checked here: column ids in [0, n), row ids in [0, m), and
    every row window inside the flat arrays.  The segment-sum kernel reads
    row r's slots as ``[row_start[r], row_start[r] + row_nnz[r])``, so
    the layout must also be the packed one it stands for: each panel's
    rows from its first slot on, within ``panel_width``, and every other
    slot padding (value +0, column 0, row 0).
    """
    m, n = shape
    indices_np = np.asarray(indices)
    row_id_np = np.asarray(row_id)
    starts = np.asarray(row_start, np.int64)[:m]
    counts = np.asarray(row_nnz, np.int64)
    ends = starts + counts
    if indices_np.size and not (0 <= indices_np.min() and indices_np.max() < n):
        raise ValueError(f"column ids outside [0, {n})")
    if row_id_np.size and not (0 <= row_id_np.min() and row_id_np.max() < max(m, 1)):
        raise ValueError(f"row ids outside [0, {m})")
    if ends.size and ends.max() > indices_np.size:
        raise ValueError("a row window runs past the flat arrays")
    R, W = int(rows_per_panel), int(panel_width)
    num_panels = -(-m // R)
    per_panel = np.zeros((num_panels * R,), np.int64)
    per_panel[:m] = counts
    per_panel = per_panel.reshape(num_panels, R)
    packed = (np.arange(num_panels)[:, None] * W + np.cumsum(per_panel, 1)
              - per_panel).reshape(-1)[:m]
    stored = np.repeat(starts, counts) + (np.arange(int(counts.sum()))
                                          - np.repeat(np.cumsum(counts) - counts, counts))
    pad = np.ones(indices_np.size, bool)
    pad[stored] = False
    want_rows = np.zeros(indices_np.size, np.int64)
    want_rows[stored] = np.repeat(np.arange(m), counts)
    pad_vals = np.asarray(data).astype(np.float32)[pad]
    if ((per_panel.sum(1) > W).any() or not np.array_equal(starts, packed)
            or not np.array_equal(row_id_np, want_rows)
            or (indices_np[pad] != 0).any() or (pad_vals != 0).any()
            or np.signbit(pad_vals).any()):
        raise ValueError("the layout is not the packed panel layout: rows "
                         "from their panel's first slot, padding +0 at "
                         "column 0, row 0")
    return CsrOp(_tensor(data, device), _tensor(indices, device),
                 _tensor(row_id, device), _tensor(row_start, device),
                 _tensor(row_nnz, device), shape=shape, nnz=int(nnz),
                 row_cap=int(row_cap), rows_per_panel=int(rows_per_panel),
                 panel_width=int(panel_width))


def ell_from_arrays(vals, cols, *, device) -> EllOp:
    """An ``EllOp`` from the ``vals``/``cols`` (n, width) of a reference
    ``EllOp``.  The kernels gather through ``cols`` with raw pointers, so
    every column id must lie in [0, n)."""
    cols_np = np.asarray(cols)
    if np.ndim(vals) != 2 or np.shape(vals) != cols_np.shape:
        raise ValueError(f"vals {np.shape(vals)} and cols {cols_np.shape} "
                         "must be equal 2-D shapes")
    n = cols_np.shape[0]
    if cols_np.size and not (0 <= cols_np.min() and cols_np.max() < n):
        raise ValueError(f"column ids outside [0, {n})")
    return EllOp(_tensor(vals, device), _tensor(cols, device))


def banded_from_arrays(A_bands, bands: int, *, device) -> BlockBandedOp:
    """A ``BlockBandedOp`` from the tiles (nb, 2*bands+1, block, block) of
    a reference ``BlockBandedOp``.  The tile shape fixes every offset the
    kernels compute, so it is checked against ``bands`` here."""
    shape = np.shape(A_bands)
    if (len(shape) != 4 or shape[1] != 2 * bands + 1 or shape[2] != shape[3]
            or bands < 0):
        raise ValueError(f"A_bands {shape} is not (nb, {2 * bands + 1}, "
                         "block, block)")
    return BlockBandedOp(_tensor(A_bands, device), bands=int(bands))
