"""Distributed asynchronous randomized (block) Gauss-Seidel on
``torch.distributed`` (port of ``repro/core/parallel_rgs.py``).

The paper's algorithm across P ranks (``DESIGN.md`` §2): the coordinates
are cut into P slabs, one a rank (owner computes); every rank keeps a
replica of the iterate, runs ``local_steps`` randomized (block) updates
of its own slab on it, and a periodic synchronization (the all-gather, or
the neighbor halo exchange on the banded format) ends each round: the
paper's Thm 4.1(a) scheme.  Its delay bound tau = (P - 1) * local_steps
is scheduled, so the step size beta~ = 1 / (1 + 2 rho tau) has a closed
form.

The three entry points are thin wrappers over
``core.distributed.solve_distributed`` with the GS action: ``DenseOp``
under the all-gather, ``BlockBandedOp`` under the all-gather or the halo
exchange.  Every rank of ``group`` calls them with the same arguments;
where the reference takes ``mesh``/``key`` they take ``group`` and
``seed`` (each rank's stream from ``seed * P + rank``) or ``picks``
(``(rounds, P, local_steps)`` slab-local block ids).  The reference's
``unroll`` (its scans' unrolling) has no counterpart: each round's local
phase is one kernel launch.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import solve_distributed
from repro_torch.core.engine import ParallelSolveResult, scheduled_tau
from repro_torch.core.operators import BlockBandedOp, DenseOp

__all__ = [
    "ParallelSolveResult",
    "effective_tau",
    "parallel_rgs_banded",
    "parallel_rgs_halo",
    "parallel_rgs_solve",
]


def effective_tau(num_workers: int, local_steps: int) -> int:
    """Scheduled staleness of the per-rank-stream schedule,
    ``engine.scheduled_tau(shared_stream=False)``."""
    return scheduled_tau(num_workers, local_steps, shared_stream=False)


def parallel_rgs_solve(
    A: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    x_star: torch.Tensor | None,
    *,
    group,
    rounds: int,
    local_steps: int,
    block: int = 1,
    beta: float = 1.0,
    seed: int | None = None,
    picks: torch.Tensor | None = None,
) -> ParallelSolveResult:
    """Solve A x = b with P-way asynchronous block RGS on the dense format.

    A: (n, n) with n divisible by P * block; b, x0, x_star: (n, k).
    """
    return solve_distributed(
        DenseOp(A), b, x0, x_star, action="gs", group=group, rounds=rounds,
        local_steps=local_steps, block=block, beta=beta, sync="allgather",
        seed=seed, picks=picks)


def parallel_rgs_banded(
    A_bands: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    x_star_or_none,
    *,
    group,
    rounds: int,
    local_steps: int,
    block: int = 128,
    bands: int = 2,
    beta: float = 1.0,
    seed: int | None = None,
    picks: torch.Tensor | None = None,
    with_metrics: bool = True,
) -> ParallelSolveResult:
    """Block-banded distributed asynchronous RGS under the all-gather.

    The matrix is held as block-band tiles ``A_bands[nb, 2*bands+1, block,
    block]`` (``kernels/bbmv.py``), so a step reads only its
    ``2*bands+1`` tiles: the paper's Θ(nnz) cost a step.
    ``with_metrics=False`` is the production inner loop (zero records).
    """
    op = BlockBandedOp(A_bands, bands=bands)
    assert op.block == block, (op.block, block)
    return solve_distributed(
        op, b, x0, x_star_or_none, action="gs", group=group, rounds=rounds,
        local_steps=local_steps, beta=beta, sync="allgather", seed=seed,
        picks=picks, with_metrics=with_metrics)


def parallel_rgs_halo(
    A_bands: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    *,
    group,
    rounds: int,
    local_steps: int,
    block: int = 128,
    bands: int = 2,
    beta: float = 1.0,
    seed: int | None = None,
    picks: torch.Tensor | None = None,
    with_metrics: bool = True,
) -> ParallelSolveResult:
    """The banded distributed RGS under the neighbor halo exchange.

    A rank's rows read x only within ``bands * block`` rows of its slab,
    so the all-gather becomes two neighbor exchanges of (bands*block, k)
    rows and a rank holds only its window; the iterates are bitwise
    ``parallel_rgs_banded``'s.  This entry point takes no ``x_star``, so
    ``err_sq`` is NaN; ``solve_distributed(..., sync="halo")`` with
    ``x_star`` records the window-local A-norm error.
    """
    op = BlockBandedOp(A_bands, bands=bands)
    assert op.block == block, (op.block, block)
    return solve_distributed(
        op, b, x0, None, action="gs", group=group, rounds=rounds,
        local_steps=local_steps, beta=beta, sync="halo", seed=seed,
        picks=picks, with_metrics=with_metrics)
