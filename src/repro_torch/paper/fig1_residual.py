"""Paper Figure 1 analogue: residual of Randomized Gauss-Seidel vs CG as the
iterations progress, on a reference-scenario matrix with multiple RHS
(equal O(nnz) work per RGS sweep / CG iteration); the counterpart of the
reference's ``benchmarks/fig1_residual.py``.

    python -m repro_torch.paper.fig1_residual [--device cpu]

Honest-reporting note, the reference's: on these synthetic
reference-scenario matrices CG leads per sweep, consistent with the
paper's own caveat ("It is not the goal of this section to show that the
suggested algorithm converges faster than ... CG for all, or many,
matrices", Sec. 8).  The paper's wall-clock advantage on its social-media
matrix came from (a) that matrix's spectrum and (b) CG's per-iteration
synchronization cost: 2 blocking all-reduce inner products + 5 multi-RHS
vector ops per iteration, vs ZERO global synchronization inside an RGS
sweep.  So the driver reports both the residual trajectories AND the
sync-point accounting that drives the paper's scalability argument.

The RGS directions come from a ``torch.Generator`` seeded 1 (the
reference's ``jax.random.key(1)``, another stream), or from ``picks=``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import cg_solve, random_sparse_spd, rgs_solve
from repro_torch.paper.common import emit


def run(n: int = 2048, rhs: int = 8, sweeps: int = 10, seed: int = 0, *,
        device=None, problem=None, picks: torch.Tensor | None = None):
    """Print a line a sweep and the summary; return the relative residual
    norms by sweep, ``(rgs, cg)``.  ``problem`` replaces
    ``random_sparse_spd(n, row_nnz=16, offdiag=0.97, n_rhs=rhs,
    seed=seed)``."""
    prob = problem or random_sparse_spd(n, row_nnz=16, offdiag=0.97,
                                        n_rhs=rhs, seed=seed, device=device)
    n = prob.n
    x0 = torch.zeros_like(prob.x_star)
    b_norm = float(torch.linalg.norm(prob.b))

    stream = ({"picks": picks} if picks is not None else
              {"generator": torch.Generator(prob.A.device).manual_seed(1)})
    res = rgs_solve(prob.A, prob.b, x0, prob.x_star, num_iters=sweeps * n,
                    record_every=n, **stream)
    cg = cg_solve(prob.A, prob.b, x0, prob.x_star, num_iters=sweeps)

    rgs_r = np.linalg.norm(res.resid.cpu().numpy(), axis=1) / b_norm
    cg_r = np.linalg.norm(cg.resid.cpu().numpy(), axis=1) / b_norm
    for s in range(sweeps):
        emit("fig1_residual", sweep=s + 1, rgs=f"{rgs_r[s]:.4e}",
             cg=f"{cg_r[s]:.4e}")
    # the paper's scalability accounting: synchronization points per unit of
    # O(nnz) work (1 sweep == 1 CG iteration), the quantity that dominates
    # at high processor counts (paper Secs. 1, 8).
    emit("fig1_residual", summary=1, kappa=f"{float(prob.kappa):.1f}",
         rgs_first_sweep=f"{rgs_r[0]:.3e}", cg_first_iter=f"{cg_r[0]:.3e}",
         rgs_wins_early=int(rgs_r[0] < cg_r[0]),
         rgs_syncs_per_sweep=0, cg_syncs_per_iter=2,
         rgs_resid_monotone=int(bool(np.all(np.diff(rgs_r) < 0))),
         cg_resid_monotone=int(bool(np.all(np.diff(cg_r) < 0))))
    return rgs_r, cg_r


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    run(device=torch.device(ap.parse_args().device))
