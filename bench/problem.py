"""A configuration's matrix as plain CSR arrays, and the packed panel layout
that ``repro_torch.convert.csr_from_arrays`` takes."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Problem:
    """A square sparse matrix in plain CSR on one device: rows sorted, each
    row's columns ascending, every diagonal entry stored.  ``b`` is the
    configuration's own right-hand side (n, 1), or None where the traffic
    draws its right-hand sides."""

    n: int
    indptr: torch.Tensor     # (n + 1,) int64
    indices: torch.Tensor    # (nnz,) int64
    data: torch.Tensor       # (nnz,) float32
    b: torch.Tensor | None = None

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())

    def row_nnz(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]


def packed_layout(p: Problem, rows_per_panel: int, lane: int = 128) -> dict:
    """The keyword arguments of ``csr_from_arrays`` for ``p``: the packed
    panel layout as that function's docstring defines it.  Each panel of
    ``rows_per_panel`` rows is padded to one width, a multiple of ``lane``
    slots; a row's slots follow the rows before it in its panel; padding
    is +0 at column 0, row 0; ``row_cap`` slack slots follow the last
    panel.  Computed on ``p``'s device and returned as numpy arrays."""
    m, R = p.n, int(rows_per_panel)
    dev = p.indptr.device
    counts = p.row_nnz()
    panels = -(-m // R)
    per_panel = torch.zeros(panels * R, dtype=torch.int64, device=dev)
    per_panel[:m] = counts
    per_panel = per_panel.view(panels, R)
    nnz = p.nnz
    row_cap = max(int(counts.max()), 1)
    width = -(-max(int(per_panel.sum(1).max()), 1) // lane) * lane
    total = panels * width + row_cap
    within = torch.cumsum(per_panel, 1) - per_panel
    starts = (torch.arange(panels, device=dev)[:, None] * width
              + within).reshape(-1)[:m]
    rows = torch.repeat_interleave(torch.arange(m, device=dev), counts,
                                   output_size=nnz)
    slot = starts[rows] + torch.arange(nnz, device=dev) - p.indptr[rows]
    data = torch.zeros(total, dtype=torch.float32, device=dev)
    cols = torch.zeros(total, dtype=torch.int32, device=dev)
    row_id = torch.zeros(total, dtype=torch.int32, device=dev)
    data[slot] = p.data
    cols[slot] = p.indices.to(torch.int32)
    row_id[slot] = rows.to(torch.int32)
    host = {key: t.cpu().numpy() for key, t in (
        ("data", data), ("indices", cols), ("row_id", row_id),
        ("row_start", starts.to(torch.int32)),
        ("row_nnz", counts.to(torch.int32)))}
    return dict(host, shape=(m, m), nnz=nnz, row_cap=row_cap,
                rows_per_panel=R, panel_width=width)
