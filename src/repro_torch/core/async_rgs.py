"""Asynchronous randomized Gauss-Seidel under the paper's bounded-delay
model (port of ``repro/core/async_rgs.py``).

Consistent read (eq. 4, Thm 4.1):
    gamma_j = (x* - x_{k(j)}, d_j)_A,   j - tau <= k(j) <= j
    x_{j+1} = x_j + beta * gamma_j d_j

Inconsistent read (eq. 16, Thm 6.1):
    gamma_j = (x* - x_{K(j)}, d_j)_A,   {0..j-tau-1} ⊆ K(j)
    x_{j+1} = x_j + beta * gamma_j d_j

``async_rgs_solve`` is a thin wrapper over the engine's bounded-delay
simulator (``core.engine.solve_async_sim`` with the "gs" action; the same
simulator drives ``async_rk_solve`` with the row action).  It takes
``generator=``/``picks=`` and ``delay_generator=``/``delays=`` where the
reference takes ``key``/``delay_key``: different streams, so the tests
hand the port the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import SolveResult, solve_async_sim
from repro_torch.core.operators import DenseOp

__all__ = ["SolveResult", "async_rgs_solve", "iteration_identity_gap"]


def async_rgs_solve(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                    x_star: torch.Tensor | None, *, num_iters: int, tau: int,
                    generator: torch.Generator | None = None,
                    picks: torch.Tensor | None = None,
                    delay_generator: torch.Generator | None = None,
                    delays: torch.Tensor | None = None, beta: float = 1.0,
                    read_model: str = "consistent",
                    delay_mode: str = "fixed", miss_prob: float = 0.5,
                    record_every: int = 0) -> SolveResult:
    """Simulate asynchronous RGS with delays bounded by ``tau``.

    delay_mode (consistent reads):
      * "fixed":    s_j = tau                      (worst case allowed by A-3)
      * "uniform":  s_j ~ U{0..tau}                (random but independent)
      * "cyclic":   s_j = j mod (tau+1)            (P processors round-robin)
    read_model "inconsistent": each of the last tau updates is invisible
    independently with prob ``miss_prob`` (K(j) = arbitrary subset, eq. 6).
    """
    return solve_async_sim(
        DenseOp(A), b, x0, x_star, action="gs", num_iters=num_iters, tau=tau,
        generator=generator, picks=picks, delay_generator=delay_generator,
        delays=delays, beta=beta, read_model=read_model,
        delay_mode=delay_mode, miss_prob=miss_prob,
        record_every=record_every)


def iteration_identity_gap(A, b, x, x_star, x_stale, r, beta=1.0):
    """Exact per-iteration identity, eq. (7)/(14), for property tests.

    Returns (lhs, rhs) of
      ||x_{j+1}-x*||_A^2 = ||x_j-x*||_A^2
                           - beta(2-beta) (x_stale - x*, d)_A^2
                           - 2 beta (x_stale - x*, d)_A (x_j - x_stale, d)_A
    which should match to rounding for any x, x_stale, r.  ``b`` is
    unused, as in the reference.
    """
    del b
    d = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    d[r] = 1.0

    def inner_a(u, v):
        return u @ (A @ v)

    gamma = inner_a(x_star - x_stale, d)
    x_next = x + beta * gamma * d
    lhs = inner_a(x_next - x_star, x_next - x_star)
    g = inner_a(x_stale - x_star, d)
    rhs = (inner_a(x - x_star, x - x_star)
           - beta * (2 - beta) * g**2
           - 2 * beta * g * inner_a(x - x_stale, d))
    return lhs, rhs
