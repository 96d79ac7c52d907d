"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package computes the
same things with PyTorch and hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``, built with ``nvcc`` at first use).  It imports
neither JAX nor ``repro``.  Entry points run on the card unless the caller
passes CPU tensors or ``device="cpu"``; on the CPU every kernel wrapper
runs its plain PyTorch version.  ``serve`` batches concurrent tenants'
right-hand sides onto the engine's serving unit (``solve_batched``);
``launch.mesh`` starts the processes of a distributed solve; ``tune`` holds the tuning table that picks the CSR
matvec variant and panel layout, and its autotuner CLI.
"""
from repro_torch.core import (BatchedSolveResult, BlockBandedOp, CsrOp,
                              DenseOp, EllOp, LSQProblem, ParallelSolveResult,
                              SPDProblem, Schedule, SolveResult, a_norm_sq,
                              as_operator, block_banded_spd, block_gs_solve,
                              dense_spd, laplacian_spd, random_sparse_lsq,
                              random_sparse_spd, scheduled_tau,
                              sequential_chunk, solve, solve_batched,
                              solve_distributed)
from repro_torch.serve import SolverService

__all__ = [
    "BatchedSolveResult",
    "BlockBandedOp",
    "CsrOp",
    "DenseOp",
    "EllOp",
    "LSQProblem",
    "ParallelSolveResult",
    "SPDProblem",
    "Schedule",
    "SolveResult",
    "SolverService",
    "a_norm_sq",
    "as_operator",
    "block_banded_spd",
    "block_gs_solve",
    "dense_spd",
    "laplacian_spd",
    "random_sparse_lsq",
    "random_sparse_spd",
    "scheduled_tau",
    "sequential_chunk",
    "solve",
    "solve_batched",
    "solve_distributed",
]
