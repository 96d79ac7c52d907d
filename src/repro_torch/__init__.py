"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package computes the
same things with PyTorch and hand-written CUDA kernels (``kernels/``,
sources in ``csrc/``, built with ``nvcc`` at first use).  It imports
neither JAX nor ``repro``.  Entry points run on the card unless the caller
passes CPU tensors or ``device="cpu"``; on the CPU every kernel wrapper
runs its plain PyTorch version.  ``serve`` batches concurrent tenants'
right-hand sides onto the engine's serving unit (``solve_batched``);
``theory`` holds the paper's rate formulas and ``cg_solve``/``fcg_solve``
its CG baselines; ``launch.solve`` and ``launch.lsq`` are the sequential
CLIs and ``launch.mesh`` starts the processes of a distributed solve;
``tune`` holds the tuning table that picks the CSR matvec variant and
panel layout, and its autotuner CLI.
"""
from repro_torch.core import (BatchedSolveResult, BlockBandedOp, CsrOp,
                              DenseOp, EllOp, LSQProblem, ParallelSolveResult,
                              SPDProblem, Schedule, SolveResult, a_norm_sq,
                              as_operator, async_rgs_solve, async_rk_solve,
                              block_banded_spd, block_gs_solve, cg_solve,
                              dense_spd, fcg_solve, laplacian_spd,
                              make_rgs_preconditioner, random_lsq,
                              random_sparse_lsq, random_sparse_spd,
                              rgs_general, rk_solve, scheduled_tau,
                              sequential_chunk, solve, solve_async_sim,
                              solve_batched, solve_distributed, theory)
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
    "async_rgs_solve",
    "async_rk_solve",
    "block_banded_spd",
    "block_gs_solve",
    "cg_solve",
    "dense_spd",
    "fcg_solve",
    "laplacian_spd",
    "make_rgs_preconditioner",
    "random_lsq",
    "random_sparse_lsq",
    "random_sparse_spd",
    "rgs_general",
    "rk_solve",
    "scheduled_tau",
    "sequential_chunk",
    "solve",
    "solve_async_sim",
    "solve_batched",
    "solve_distributed",
    "theory",
]
