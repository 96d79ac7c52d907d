"""Synchronous randomized Gauss-Seidel wrappers (port of
``repro/core/rgs.py``; the paper's §2.2).

Iteration (1): pick ``r`` uniformly; ``gamma = (b - A x)_r``;
``x_r += beta * gamma``.  Multi-RHS: x and b are (n, k), one direction for
all k columns, as in the paper's experiments.

``rgs_solve`` and ``block_gs_solve`` are thin wrappers over the sequential
engine (``core/engine.py``) on a ``DenseOp``.  They take ``generator=`` or
``picks=`` where the reference takes a ``jax.random`` key.  The
non-unit-diagonal iteration ``rgs_general`` takes explicit directions and
stays a plain loop.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import (SolveResult, record_metrics,
                                     solve_sequential)
from repro_torch.core.operators import DenseOp

__all__ = ["SolveResult", "block_gs_solve", "rgs_general", "rgs_solve"]


def _record(A, b, x, x_star):
    """A-norm error and residual of dense ``A`` per column (the recording
    helper ``cg.py`` uses): ``record_metrics`` on a ``DenseOp``, so the
    products run in fixed column groups and the sums through
    ``ops.colsum``, and a column's record does not depend on how many
    columns ride along."""
    return record_metrics(DenseOp(A), b, x, x_star, norm="A")


def rgs_solve(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
              x_star: torch.Tensor | None, *, num_iters: int,
              generator: torch.Generator | None = None,
              picks: torch.Tensor | None = None, beta: float = 1.0,
              record_every: int = 0) -> SolveResult:
    """``num_iters`` randomized coordinate-GS iterations; records every
    ``record_every`` iterations (0: only at the end)."""
    return solve_sequential(
        DenseOp(A), b, x0, x_star, action="gs", num_iters=num_iters,
        generator=generator, picks=picks, beta=beta, block=1,
        record_every=record_every)


def block_gs_solve(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                   x_star: torch.Tensor | None, *, num_sweeps: int,
                   block: int, generator: torch.Generator | None = None,
                   picks: torch.Tensor | None = None,
                   beta: float = 1.0) -> SolveResult:
    """Randomized block GS (the TPU-adapted granularity, ``DESIGN.md`` §2):
    each step picks an aligned block of ``block`` coordinates and applies
    ``x_B += beta * (b - A x)_B``.  One sweep is ``n // block`` steps, one
    record per sweep; on the card each sweep is one launch of the
    ``block_gs_sweep`` kernel."""
    nb = A.shape[0] // block
    return solve_sequential(
        DenseOp(A), b, x0, x_star, action="gs", num_iters=num_sweeps * nb,
        generator=generator, picks=picks, beta=beta, block=block,
        record_every=nb)


def rgs_general(B: torch.Tensor, z: torch.Tensor, y0: torch.Tensor, *,
                coords, beta: float = 1.0,
                num_iters: int | None = None) -> torch.Tensor:
    """Non-unit-diagonal iteration (3):
    ``gamma~ = (z - B y)_r / B_rr``; ``y_r += beta * gamma~``.  Directions
    are given explicitly (``coords``, read to the host once) so the
    rescaling-equivalence test can share them with the unit-diagonal run.
    ``num_iters`` is accepted for the reference's signature and unused.
    Returns a new y."""
    del num_iters
    y = y0.clone()
    for r in torch.as_tensor(coords).cpu().tolist():
        gamma = (z[r] - B[r] @ y) / B[r, r]
        y[r] += beta * gamma
    return y
