"""The control of the correctness check: the program one precision step
below what the configurations state.

Both configurations state float32 coefficients.  The program has a path
of its own one step below, bfloat16 coefficient storage
(``storage_dtype="bfloat16"``: the values rounded to bfloat16, the column
ids narrowed to int16 where every id fits, the iterate and all sums still
float32).  ``bf16`` turns that path on for an operator that set-up built,
as ``CsrOp.from_dense(..., storage_dtype="bfloat16")`` would store it.
"""
from __future__ import annotations

import torch


def bf16(op):
    from repro_torch.core.operators import CsrOp

    cols = (op.indices.to(torch.int16)
            if op.shape[1] <= torch.iinfo(torch.int16).max else op.indices)
    return CsrOp(op.data.to(torch.bfloat16), cols, op.row_id, op.row_start,
                 op.row_nnz, shape=op.shape, nnz=op.nnz, row_cap=op.row_cap,
                 rows_per_panel=op.rows_per_panel,
                 panel_width=op.panel_width)
