"""Quickstart: solve an SPD system with the paper's solvers (the
counterpart of the reference's ``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--n 1024] [--device cpu]

Builds a reference-scenario sparse SPD system (unit diagonal after the
Sec. 2.3 rescaling), then solves it three ways:
  1. synchronous randomized Gauss-Seidel (Leventhal-Lewis),
  2. asynchronous randomized GS under bounded delay, with the Sec. 5
     optimal step size beta~ = 1/(1 + 2 rho tau),
  3. CG (the paper's baseline).

The directions come from a ``torch.Generator`` seeded 1 and the delays
from one seeded 2 (the reference's keys' integers, another stream), or
from ``picks=`` and ``delays=``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (Schedule, cg_solve, random_sparse_spd, solve,
                              theory)

SWEEPS, TAU = 10, 32


def run(n: int = 1024, *, device=None, problem=None,
        picks: torch.Tensor | None = None,
        delays: torch.Tensor | None = None) -> dict:
    """Print the three solves' relative residuals; return the results
    (``sync``, ``async``, ``cg``) and ``beta``.  ``problem`` replaces
    ``random_sparse_spd(n, row_nnz=16, offdiag=0.95, n_rhs=4, seed=0)``."""
    prob = problem or random_sparse_spd(n, row_nnz=16, offdiag=0.95,
                                        n_rhs=4, seed=0, device=device)
    n, dev = prob.n, prob.A.device
    x0 = torch.zeros_like(prob.x_star)
    bn = float(torch.linalg.norm(prob.b))
    print(f"n={n}, nnz/row~32, kappa={float(prob.kappa):.1f}, 4 right-hand "
          "sides")

    def seeded(seed):
        return torch.Generator(dev).manual_seed(seed)

    def directions():
        return ({"picks": picks} if picks is not None
                else {"generator": seeded(1)})

    # the unified front door: solve(problem, format=..., schedule=...)
    res = solve(prob, **directions(),
                schedule=Schedule(num_iters=SWEEPS * n, record_every=n))
    for s in (1, 5, 10):
        print(f"  sync RGS  sweep {s:2d}: relative residual "
              f"{float(torch.linalg.norm(res.resid[s - 1])) / bn:.3e}")

    rho = float(theory.rho(prob.A))
    beta = theory.beta_opt(rho, TAU)
    # tau > 0 routes to the bounded-delay simulator of the paper's Sec. 4
    ares = solve(prob, **directions(), beta=beta, delay_mode="uniform",
                 **({"delays": delays} if delays is not None
                    else {"delay_generator": seeded(2)}),
                 schedule=Schedule(num_iters=SWEEPS * n, tau=TAU,
                                   record_every=n))
    print(f"  async RGS (tau={TAU}, beta~={beta:.3f}) sweep {SWEEPS}: "
          f"relative residual "
          f"{float(torch.linalg.norm(ares.resid[-1])) / bn:.3e}")

    cg = cg_solve(prob.A, prob.b, x0, prob.x_star, num_iters=SWEEPS)
    print(f"  CG        iter  {SWEEPS}: relative residual "
          f"{float(torch.linalg.norm(cg.resid[-1])) / bn:.3e}")
    print("note: RGS sweeps and CG iterations cost the same O(nnz) work")
    return {"sync": res, "async": ares, "cg": cg, "beta": beta}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="where the problem and the solves live (cuda "
                         "raises without a card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    return run(args.n, device=torch.device(args.device))


if __name__ == "__main__":
    main()
