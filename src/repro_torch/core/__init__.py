"""repro_torch.core — the paper's randomized solvers on PyTorch: problems
(``spd``, ``kaczmarz``), matrix formats (``operators``), the sequential
engine with its front door ``solve``, its bounded-delay simulator
``solve_async_sim`` and its serving unit ``solve_batched`` (``engine``),
the dense GS wrappers (``rgs``, ``async_rgs``), the CG baselines
(``cg``), the rate formulas (``theory``) and the distributed engine on
``torch.distributed`` (``distributed``) with its GS wrappers
(``parallel_rgs``), ``parallel_rk_solve`` and its slab assignment
(``partition``)."""

from repro_torch.core import distributed, engine, partition, theory
from repro_torch.core.async_rgs import async_rgs_solve, iteration_identity_gap
from repro_torch.core.cg import cg_solve, fcg_solve, make_rgs_preconditioner
from repro_torch.core.distributed import solve_distributed
from repro_torch.core.engine import (BatchedSolveResult,
                                     ParallelSolveResult, Schedule,
                                     SolveResult, draw_picks, record_metrics,
                                     sample_rows, scheduled_tau,
                                     sequential_chunk, solve, solve_async_sim,
                                     solve_batched, solve_sequential)
from repro_torch.core.kaczmarz import (LSQProblem, async_rk_solve,
                                       parallel_rk_solve, random_lsq,
                                       random_sparse_lsq, rk_effective_tau,
                                       rk_solve, row_norms_sq)
from repro_torch.core.operators import (BlockBandedOp, CsrOp, DenseOp, EllOp,
                                        as_operator)
from repro_torch.core.parallel_rgs import (effective_tau, parallel_rgs_banded,
                                           parallel_rgs_halo,
                                           parallel_rgs_solve)
from repro_torch.core.rgs import block_gs_solve, rgs_general, rgs_solve
from repro_torch.core.spd import (SPDProblem, a_norm_sq, block_banded_spd,
                                  dense_spd, ell_from_dense, laplacian_spd,
                                  random_sparse_spd, to_unit_diagonal)

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
    "a_norm_sq",
    "as_operator",
    "async_rgs_solve",
    "async_rk_solve",
    "block_banded_spd",
    "block_gs_solve",
    "cg_solve",
    "dense_spd",
    "distributed",
    "draw_picks",
    "effective_tau",
    "ell_from_dense",
    "engine",
    "fcg_solve",
    "iteration_identity_gap",
    "laplacian_spd",
    "make_rgs_preconditioner",
    "parallel_rgs_banded",
    "parallel_rgs_halo",
    "parallel_rgs_solve",
    "parallel_rk_solve",
    "partition",
    "random_lsq",
    "random_sparse_lsq",
    "random_sparse_spd",
    "record_metrics",
    "rgs_general",
    "rgs_solve",
    "rk_effective_tau",
    "rk_solve",
    "row_norms_sq",
    "sample_rows",
    "scheduled_tau",
    "sequential_chunk",
    "solve",
    "solve_async_sim",
    "solve_batched",
    "solve_distributed",
    "solve_sequential",
    "theory",
    "to_unit_diagonal",
]
