"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package computes the
same things with PyTorch and hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``, built with ``nvcc`` at first use).  It imports
neither JAX nor ``repro``.  Entry points run on the card unless the caller
passes CPU tensors or ``device="cpu"``; on the CPU every kernel wrapper
runs its plain PyTorch version.  ``launch.mesh`` starts the processes of
a distributed solve; ``tune`` holds the tuning table that picks the CSR
matvec variant and panel layout, and its autotuner CLI.
"""
from repro_torch.core import (BlockBandedOp, CsrOp, DenseOp, EllOp,
                              LSQProblem, ParallelSolveResult, SPDProblem,
                              Schedule, SolveResult, a_norm_sq, as_operator,
                              block_banded_spd, block_gs_solve, dense_spd,
                              laplacian_spd,
                              random_sparse_lsq, random_sparse_spd,
                              scheduled_tau, solve, solve_distributed)

__all__ = [
    "BlockBandedOp",
    "CsrOp",
    "DenseOp",
    "EllOp",
    "LSQProblem",
    "ParallelSolveResult",
    "SPDProblem",
    "Schedule",
    "SolveResult",
    "a_norm_sq",
    "as_operator",
    "block_banded_spd",
    "block_gs_solve",
    "dense_spd",
    "laplacian_spd",
    "random_sparse_lsq",
    "random_sparse_spd",
    "scheduled_tau",
    "solve",
    "solve_distributed",
]
