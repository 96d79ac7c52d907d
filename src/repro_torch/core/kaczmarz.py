"""Least-squares problems and randomized Kaczmarz (port of
``repro/core/kaczmarz.py``, the paper's Sec. 7).

``random_lsq`` (dense Gaussian design) and ``random_sparse_lsq`` run the
reference's numpy construction line for line, so ``A``, ``x_true`` and
``b`` are bitwise the reference's; the singular values (and, with noise,
the least-squares solution) are computed on ``device`` (``None``: the
card).

``rk_solve`` (sequential) and ``async_rk_solve`` (the bounded-delay
simulator) are thin wrappers over the engine's ``"rk"`` action on a
``DenseOp``.  They take ``generator=``/``picks=`` (and
``delay_generator=``/``delays=``) where the reference takes ``jax.random``
keys: different streams, so the tests hand the port the reference's.
``parallel_rk_solve`` is the distributed engine's ``dense_rk`` strategy on
a ``torch.distributed`` process group.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import (ParallelSolveResult, SolveResult,
                                     scheduled_tau, solve_async_sim,
                                     solve_sequential)
from repro_torch.core.operators import DenseOp
from repro_torch.core.spd import resolve_device

__all__ = ["LSQProblem", "async_rk_solve", "parallel_rk_solve",
           "random_lsq", "random_sparse_lsq", "rk_effective_tau", "rk_solve",
           "row_norms_sq"]


class LSQProblem(NamedTuple):
    """An overdetermined system ``A x ~= b`` with known LSQ solution."""

    A: torch.Tensor        # (m, n) rectangular, m >= n
    b: torch.Tensor        # (m, k) right-hand sides
    x_star: torch.Tensor   # (n, k) least-squares solution argmin ||A x - b||
    x_true: torch.Tensor   # (n, k) planted coefficients (== x_star iff noise=0)
    sigma_min: torch.Tensor
    sigma_max: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.A.shape)

    @property
    def kappa(self) -> torch.Tensor:
        return self.sigma_max / self.sigma_min


def _finish(A, b, x_true, noise, device) -> LSQProblem:
    """The problem on ``device``: the least-squares solution by ``lstsq``
    when there is noise (else the planted coefficients), and the singular
    values, both computed there.  ``lstsq`` returns its solution
    column-major; it is made contiguous, as the record sums need."""
    A_t = torch.from_numpy(A).to(device)
    b_t = torch.from_numpy(b).to(device)
    x_true_t = torch.from_numpy(x_true).to(device)
    x_star = (torch.linalg.lstsq(A_t, b_t).solution.contiguous() if noise
              else x_true_t)
    s = torch.linalg.svdvals(A_t)
    return LSQProblem(A=A_t, b=b_t, x_star=x_star, x_true=x_true_t,
                      sigma_min=s[-1], sigma_max=s[0])


def random_lsq(
    m: int,
    n: int,
    *,
    n_rhs: int = 1,
    noise: float = 0.0,
    col_scale: float = 1.0,
    seed: int = 0,
    device=None,
) -> LSQProblem:
    """Gaussian design with exponentially skewed column scales (the shape of
    the paper's regression features), planted coefficients, optional noise.

    ``noise = 0`` gives a consistent system (RK converges to x* exactly);
    ``noise > 0`` a genuine least-squares problem where RK reaches the
    low-accuracy neighborhood of x*.
    """
    if m < n:
        raise ValueError(f"need m >= n, got ({m}, {n})")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    if col_scale:
        A *= rng.exponential(col_scale, n).astype(np.float32)
    x_true = rng.standard_normal((n, n_rhs)).astype(np.float32)
    b = A @ x_true
    if noise:
        b = b + noise * rng.standard_normal((m, n_rhs)).astype(np.float32)
    return _finish(A, b, x_true, noise, device)


def random_sparse_lsq(
    m: int,
    n: int,
    *,
    row_nnz: int = 8,
    n_rhs: int = 1,
    noise: float = 0.0,
    seed: int = 0,
    device=None,
) -> LSQProblem:
    """Sparse overdetermined design: ``row_nnz`` nonzeros per row, planted
    coefficients, optional noise — the rectangular face of the paper's
    reference scenario (unstructured sparsity, few nnz/row)."""
    if m < n:
        raise ValueError(f"need m >= n, got ({m}, {n})")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n), np.float32)
    for i in range(m):
        cols = rng.choice(n, size=row_nnz, replace=False)
        A[i, cols] = rng.standard_normal(row_nnz).astype(np.float32)
    x_true = rng.standard_normal((n, n_rhs)).astype(np.float32)
    b = A @ x_true
    if noise:
        b = b + noise * rng.standard_normal((m, n_rhs)).astype(np.float32)
    return _finish(A, b, x_true, noise, device)


def row_norms_sq(A: torch.Tensor) -> torch.Tensor:
    """||A_i||^2 per row — the (unnormalized) sampling distribution."""
    A = A.float()
    return (A * A).sum(1)


def rk_solve(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
             x_star: torch.Tensor | None, *, num_iters: int,
             generator: torch.Generator | None = None,
             picks: torch.Tensor | None = None, beta: float = 1.0,
             record_every: int = 0) -> SolveResult:
    """Sequential randomized Kaczmarz on ``A x ~= b`` (A rectangular, b
    (m, k): one row serves all k right-hand sides).  ``err_sq`` records
    ||x - x*||_2^2, ``resid`` ||b - A x||_2 per RHS."""
    return solve_sequential(
        DenseOp(A), b, x0, x_star, action="rk", num_iters=num_iters,
        generator=generator, picks=picks, beta=beta,
        record_every=record_every)


def async_rk_solve(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                   x_star: torch.Tensor | None, *, num_iters: int, tau: int,
                   generator: torch.Generator | None = None,
                   picks: torch.Tensor | None = None,
                   delay_generator: torch.Generator | None = None,
                   delays: torch.Tensor | None = None, beta: float = 1.0,
                   read_model: str = "consistent",
                   delay_mode: str = "fixed", miss_prob: float = 0.5,
                   record_every: int = 0) -> SolveResult:
    """Asynchronous RK under the paper's bounded-delay model: the engine's
    ring-buffer simulator with the row action, the stale read rebuilt
    exactly as ``A_r x_{k(j)} = A_r x_j - sum_{t invisible} c_t <A_r,
    A_{r_t}>``.  Delays come from ``delay_generator`` (or ``delays``),
    independent of the row stream (Assumption A-4); ``delay_mode`` and
    ``read_model`` as in ``engine.solve_async_sim``."""
    return solve_async_sim(
        DenseOp(A), b, x0, x_star, action="rk", num_iters=num_iters, tau=tau,
        generator=generator, picks=picks, delay_generator=delay_generator,
        delays=delays, beta=beta, read_model=read_model,
        delay_mode=delay_mode, miss_prob=miss_prob,
        record_every=record_every)


def rk_effective_tau(num_workers: int, local_steps: int) -> int:
    """Scheduled staleness bound of the shared-stream distributed RK
    (``engine.scheduled_tau(shared_stream=True)``): within a round a pick
    misses at most the other workers' earlier in-round updates."""
    return scheduled_tau(num_workers, local_steps, shared_stream=True)


def parallel_rk_solve(
    A: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    x_star: torch.Tensor | None,
    *,
    group,
    rounds: int,
    local_steps: int,
    beta: float = 1.0,
    seed: int | None = None,
    picks: torch.Tensor | None = None,
) -> ParallelSolveResult:
    """Distributed asynchronous RK: rows cut into P slabs (owner
    computes); call it on every rank of ``group``.

    The schedule is one global i.i.d. row stream of ``rounds *
    local_steps`` picks (from ``seed``, the same on every rank, else
    ``picks`` of shape ``(rounds, local_steps)``, global row ids),
    partitioned by row owner: within a round every rank applies its own
    picks with fresh reads while the other ranks' updates stay invisible
    until the round's delta sum, with scheduled staleness
    ``rk_effective_tau(P, local_steps)``.  At P = 1 every pick is owned
    and nothing is exchanged.  ``err_sq``/``resid`` are recorded once a
    round.  Where the reference takes ``mesh``/``key`` this takes
    ``group`` and ``seed`` or ``picks``; its ``unroll`` has no
    counterpart (each round's local phase is one kernel launch).
    """
    from repro_torch.core.distributed import solve_distributed
    return solve_distributed(
        DenseOp(A), b, x0, x_star, action="rk", group=group, rounds=rounds,
        local_steps=local_steps, beta=beta, sync="psum", seed=seed,
        picks=picks)
