"""HPCG's reference problem (HPCG 3.1, ``GenerateProblem``): the 27-point
stencil on an nx x ny x nz grid, 26 on the diagonal and -1 for each
neighbour inside the grid, ``b = A 1``, exact solution 1.

Rows are numbered x fastest, then y, then z, and each row's neighbours in
HPCG's loop order (z, then y, then x, each from -1 to 1), so its columns
ascend.  A and b are divided by 26, which leaves the solution unchanged
and gives the unit diagonal that the paper's Gauss-Seidel update assumes.
The values are float32; ``b`` is ``(27 - nnz_row) / 26`` rounded once.
Deterministic: nothing is drawn.
"""
from __future__ import annotations

import torch

from bench.problem import Problem


def generate(config: dict, device) -> Problem:
    nx, ny, nz = int(config["nx"]), int(config["ny"]), int(config["nz"])
    n = nx * ny * nz
    row = torch.arange(n, device=device)
    ix, iy, iz = row % nx, (row // nx) % ny, row // (nx * ny)
    step = torch.tensor([-1, 0, 1], device=device)
    dz, dy, dx = (t.reshape(-1) for t in torch.meshgrid(step, step, step,
                                                        indexing="ij"))
    cx, cy, cz = ix[:, None] + dx, iy[:, None] + dy, iz[:, None] + dz
    inside = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
              & (cz >= 0) & (cz < nz))
    cols = (cz * ny + cy) * nx + cx
    counts = inside.sum(1)
    centre = (dx == 0) & (dy == 0) & (dz == 0)
    vals = torch.where(centre, 26.0, -1.0).to(torch.float64) / 26.0
    data = vals.expand(n, -1)[inside].to(torch.float32)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    b = ((27 - counts).to(torch.float64) / 26.0).to(torch.float32)
    return Problem(n=n, indptr=indptr, indices=cols[inside], data=data,
                   b=b[:, None].contiguous())
