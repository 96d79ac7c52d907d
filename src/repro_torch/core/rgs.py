"""Synchronous randomized Gauss-Seidel wrappers (port of
``repro/core/rgs.py``; the paper's §2.2).

Iteration (1): pick ``r`` uniformly; ``gamma = (b - A x)_r``;
``x_r += beta * gamma``.  Multi-RHS: x and b are (n, k), one direction for
all k columns, as in the paper's experiments.

``rgs_solve`` and ``block_gs_solve`` are thin wrappers over the sequential
engine (``core/engine.py``) on a ``DenseOp``.  They take ``generator=`` or
``picks=`` where the reference takes a ``jax.random`` key.  The
non-unit-diagonal iteration ``rgs_general`` is not ported yet (ROADMAP
queue 1 item 6).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import SolveResult, solve_sequential
from repro_torch.core.operators import DenseOp

__all__ = ["SolveResult", "block_gs_solve", "rgs_solve"]


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
