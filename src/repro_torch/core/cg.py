"""Conjugate Gradients (the paper's baseline, Sec. 8) and flexible CG
preconditioned by randomized block Gauss-Seidel sweeps (the paper's
proposed future-work path, Sec. 8/9); port of ``repro/core/cg.py``.

Multi-RHS throughout: b, x are (n, k) and every scalar of textbook CG
becomes a (k,) vector (the paper solves 51 systems with a shared A).  The
products go through ``DenseOp.matvec`` (fixed 64-column groups) and the
column dots through ``ops.colsum``, so a column's iterates do not depend on
how many columns ride along.  The preconditioner's sweeps are one
``block_gs_sweep`` launch per application on the card.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.engine import SolveResult
from repro_torch.core.operators import DenseOp
from repro_torch.core.rgs import _record
from repro_torch.kernels import ops

__all__ = ["cg_solve", "fcg_solve", "make_rgs_preconditioner"]


def _dense_columns(*ts):
    """The (n, k) inputs as contiguous tensors (a product such as
    ``A.T @ b`` may come back column-major), so that every product of
    them is a contiguous input of ``ops.colsum``."""
    return tuple(None if t is None else t.contiguous() for t in ts)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column dot products of two (n, k) tensors, (k,)."""
    return ops.colsum(u * v)


def cg_solve(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
             x_star: torch.Tensor | None, *, num_iters: int) -> SolveResult:
    """``num_iters`` CG iterations on every column, one record each.  A
    column whose residual reaches machine zero (``rs <= 1e-30``) is frozen:
    its step and its direction update are 0, and both divisions are
    guarded by ``max(., 1e-30)`` so a frozen column stays finite."""
    op = DenseOp(A)
    b, x0, x_star = _dense_columns(b, x0, x_star)
    r = b - op.matvec(x0)
    x, p, rs = x0, r, _dot(r, r)
    errs, resids = [], []
    for _ in range(num_iters):
        Ap = op.matvec(p)
        live = rs > 1e-30
        alpha = torch.where(live, rs / torch.clamp(_dot(p, Ap), min=1e-30),
                            0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r)
        p = r + torch.where(live, rs_new / torch.clamp(rs, min=1e-30),
                            0.0) * p
        rs = rs_new
        err, resid = _record(A, b, x, x_star)
        errs.append(err)
        resids.append(resid)
    return SolveResult(x=x, err_sq=torch.stack(errs),
                       resid=torch.stack(resids),
                       iters=1 + torch.arange(num_iters, device=x.device))


def make_rgs_preconditioner(A: torch.Tensor, *, sweeps: int, block: int,
                            beta: float, seed: int = 7,
                            block_streams: Sequence | None = None):
    """M^{-1} r ~= ``sweeps`` randomized block-GS sweeps on A z = r from
    z = 0: ``z[B] += beta * (r[B] - A[B, :] z)`` over ``sweeps * (n //
    block)`` random aligned blocks, one ``DenseOp.block_gs_sweep`` call
    (one kernel launch on the card) per application.

    The i-th application draws its blocks from a ``torch.Generator``
    seeded ``seed + i`` on A's device (a different stream from the
    reference's ``jax.random.key(seed + i)``), or takes
    ``block_streams[i]`` when given.  The preconditioner is a changing
    linear operator (fresh blocks per application), which is why flexible
    CG is required (Sec. 8).
    """
    op = DenseOp(A)
    nb = A.shape[0] // block
    counter = {"i": 0}

    def apply(r: torch.Tensor) -> torch.Tensor:
        i = counter["i"]
        counter["i"] += 1
        if block_streams is not None:
            blocks = torch.as_tensor(block_streams[i], device=A.device)
        else:
            gen = torch.Generator(A.device).manual_seed(seed + i)
            blocks = torch.randint(0, nb, (sweeps * nb,), generator=gen,
                                   device=A.device)
        return op.block_gs_sweep(r, torch.zeros_like(r), blocks, block=block,
                                 beta=beta)

    return apply


def fcg_solve(A: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
              x_star: torch.Tensor | None, *,
              precond: Callable[[torch.Tensor], torch.Tensor],
              num_iters: int) -> SolveResult:
    """Flexible CG (Notay's FCG(1)): beta via the Polak-Ribiere-like form
    beta = (z_{i+1}, r_{i+1} - r_i) / (z_i, r_i), robust to a
    preconditioner that changes between iterations."""
    op = DenseOp(A)
    b, x0, x_star = _dense_columns(b, x0, x_star)
    x, r = x0, b - op.matvec(x0)
    z = precond(r)
    p = z
    zr = _dot(z, r)
    errs, resids = [], []
    for _ in range(num_iters):
        Ap = op.matvec(p)
        alpha = zr / _dot(p, Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        zr_new = _dot(z, r_new)
        beta = _dot(z, r_new - r) / zr
        p = z + beta * p
        r, zr = r_new, zr_new
        err, resid = _record(A, b, x, x_star)
        errs.append(err)
        resids.append(resid)
    return SolveResult(x=x, err_sq=torch.stack(errs),
                       resid=torch.stack(resids),
                       iters=1 + torch.arange(num_iters, device=x.device))
