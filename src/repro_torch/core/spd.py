"""SPD problem construction and normalization (port of ``repro/core/spd.py``).

The paper assumes WLOG a unit diagonal (Sec. 2.3): for a general SPD ``B``
we solve ``A x = D z`` with ``A = D B D``, ``D = diag(B)^{-1/2}``.  The
generator below produces the paper's *reference scenario*: large sparse
SPD with few nonzeros per row.

The matrix comes from the same numpy RNG construction as the reference, so
``A`` is bitwise the reference's after the same f32 cast.  ``x_star`` (and
so ``b``) is drawn from a ``torch.Generator`` seeded with ``seed + 1``:
a different stream from the reference's ``jax.random`` threefry key, so
parity tests take ``b``/``x_star`` from the reference problem
(``repro_torch.convert.spd_problem_from_numpy``).

Problems are built on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises when there is no CUDA device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SPDProblem(NamedTuple):
    """A unit-diagonal SPD system ``A x = b`` with known solution."""

    A: torch.Tensor        # (n, n) dense, unit diagonal, SPD
    b: torch.Tensor        # (n, k) right-hand sides (the paper uses k = 51)
    x_star: torch.Tensor   # (n, k) exact solution
    lam_min: torch.Tensor
    lam_max: torch.Tensor

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def kappa(self) -> torch.Tensor:
        return self.lam_max / self.lam_min


def resolve_device(device) -> torch.device:
    """``None`` means the card; without a CUDA device that is an error,
    never a silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to build the problem on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_unit_diagonal(B: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Return ``(A, d)`` with ``A = D B D`` unit-diagonal, ``D = diag(d)``.

    The square root is taken in f64 and rounded once: the correctly rounded
    root on every device, as the reference's is (PyTorch's vectorized f32
    square root on the CPU is not), so ``A`` is bitwise the reference's.
    """
    d = 1.0 / torch.sqrt(torch.diagonal(B).double()).to(B.dtype)
    A = B * d[:, None] * d[None, :]
    # Exact ones on the diagonal (kills rounding fuzz that breaks (d,d)_A = 1).
    A.fill_diagonal_(1.0)
    return A, d


def _finish(A: np.ndarray, n_rhs: int, seed: int, device) -> SPDProblem:
    A = torch.from_numpy(np.asarray(A, np.float32)).to(device)
    A, _ = to_unit_diagonal(A)
    evals = torch.linalg.eigvalsh(A)
    gen = torch.Generator(device).manual_seed(seed + 1)
    x_star = torch.randn((A.shape[0], n_rhs), generator=gen, device=device,
                         dtype=A.dtype)
    b = A @ x_star
    return SPDProblem(A=A, b=b, x_star=x_star, lam_min=evals[0],
                      lam_max=evals[-1])


def random_sparse_spd(
    n: int,
    row_nnz: int = 8,
    *,
    offdiag: float = 0.9,
    n_rhs: int = 1,
    seed: int = 0,
    device=None,
) -> SPDProblem:
    """Reference-scenario matrix: ~``row_nnz`` nonzeros/row, unit diagonal.

    ``A = I + c * (S + S^T)/2`` with ``c`` chosen via Gershgorin so that
    ``lam_min >= 1 - offdiag > 0``.  The host construction is the
    reference's, line for line; the eigenvalues, ``x_star`` and ``b`` are
    computed on ``device`` (``None``: the card).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    M = np.zeros((n, n))
    for i in range(n):
        cols = rng.choice(n, size=row_nnz, replace=False)
        M[i, cols] = rng.standard_normal(row_nnz)
    M = (M + M.T) / 2.0
    np.fill_diagonal(M, 0.0)
    s = np.abs(M).sum(axis=1).max()
    M *= offdiag / max(s, 1e-30)
    A = np.eye(n) + M
    return _finish(A, n_rhs, seed, device)


def laplacian_spd(side: int, *, shift: float = 1e-2, n_rhs: int = 1,
                  seed: int = 0, device=None) -> SPDProblem:
    """2-D grid Laplacian + shift, unit-diagonal-normalized.

    Ill-conditioned as ``side`` grows (kappa ~ side^2 / shift).  Every
    off-diagonal entry is the same, so its rows are full of magnitude ties
    (the case ``ell_from_dense`` must order as the reference does).
    """
    device = resolve_device(device)
    n = side * side
    A = np.zeros((n, n))
    for i in range(side):
        for j in range(side):
            p = i * side + j
            A[p, p] = 4.0 + shift
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                q_i, q_j = i + di, j + dj
                if 0 <= q_i < side and 0 <= q_j < side:
                    A[p, q_i * side + q_j] = -1.0
    return _finish(A, n_rhs, seed, device)


def dense_spd(n: int, *, n_rhs: int = 1, seed: int = 0,
              device=None) -> SPDProblem:
    """Dense Wishart-plus-identity SPD ``G G^T / n + I``, scaled to a unit
    diagonal (outside the paper's sparse scenario; the dense block-GS
    path's problem).  The host construction is the reference's, line for
    line."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    A = G @ G.T / n + np.eye(n)
    return _finish(A, n_rhs, seed, device)


def block_banded_spd(n: int, *, block: int = 128, bands: int = 2,
                     offdiag: float = 0.9, n_rhs: int = 1, seed: int = 0,
                     device=None) -> SPDProblem:
    """Block-banded SPD: nonzeros in ``bands`` blocks of width ``block`` on
    each side of the diagonal, identity diagonal blocks.  The host
    construction is the reference's, line for line."""
    if n % block:
        raise ValueError(f"n ({n}) must be a multiple of block ({block})")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    nb = n // block
    M = np.zeros((n, n))
    for bi in range(nb):
        for bj in range(max(0, bi - bands), min(nb, bi + bands + 1)):
            if bi == bj:
                continue
            blk = rng.standard_normal((block, block)) / block
            M[bi * block:(bi + 1) * block, bj * block:(bj + 1) * block] = blk
    M = (M + M.T) / 2.0
    np.fill_diagonal(M, 0.0)
    s = np.abs(M).sum(axis=1).max()
    M *= offdiag / max(s, 1e-30)
    A = np.eye(n) + M
    return _finish(A, n_rhs, seed, device)


def ell_from_dense(A: torch.Tensor,
                   width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width ELL of dense ``A``: values (n, width), int32 cols (n, width).

    Keeps the ``width`` largest-magnitude entries of each row (exact when
    every row has <= width nonzeros), in descending magnitude with ties in
    lower-column-first order, as the reference's ``lax.top_k`` orders them;
    a stable descending sort gives that order (``torch.topk`` does not).
    Padding slots hold value 0 and the row's own index, so gathers stay in
    bounds.
    """
    n = A.shape[0]
    if not 0 < width <= A.shape[1]:
        raise ValueError(f"width ({width}) must lie in [1, {A.shape[1]}]")
    mag = A.abs()
    cols = torch.sort(mag, dim=1, descending=True,
                      stable=True).indices[:, :width]
    keep = mag.gather(1, cols) > 0
    vals = torch.where(keep, A.gather(1, cols), torch.zeros((), dtype=A.dtype,
                                                            device=A.device))
    own = torch.arange(n, device=A.device)[:, None].expand(n, width)
    return vals, torch.where(keep, cols, own).to(torch.int32)


def a_norm_sq(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``||v||_A^2`` per RHS column: v is (n,) or (n, k)."""
    if v.ndim == 1:
        return v @ (A @ v)
    return (v * (A @ v)).sum(0)
