"""Paper Sec. 7/8 analogue: multi-RHS linear regression via randomized
Kaczmarz, directly on the design matrix, no normal equations (the
counterpart of the reference's ``examples/solve_regression.py``).

    python -m repro_torch.examples.solve_regression [--samples 4096]
        [--features 1024] [--targets 51] [--device cpu]

The paper's regression workload (120k x 120k normal equations, 51 targets,
~10 sweeps of accuracy) is solved on the rows of X itself, so the
contraction is governed by kappa(X) instead of kappa(X)^2, and each update
touches one row: the per-iteration cost profile the paper's asynchronous
analysis assumes.

X, Y and W_true come from the reference's numpy construction with its
seed, so on the CPU the problem is bitwise the reference's.  The rows
come from a ``torch.Generator`` seeded 0 (the reference's key's integer,
another stream), or from ``picks=``; the async solve's delays are fixed at
tau and draw nothing from the generator seeded 1 that mirrors the
reference's delay key.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (LSQProblem, Schedule, cg_solve, solve, theory,
                              to_unit_diagonal)
from repro_torch.core.spd import resolve_device
from repro_torch.launch.solve import wait

SWEEPS, TAU = 10, 64


def build_problem(n_samples=4096, n_features=1024, n_targets=51, seed=0):
    """(X, Y, W_true) as numpy f32 arrays, the reference's construction."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_samples, n_features)).astype(np.float32)
    X *= rng.exponential(1.0, n_features).astype(np.float32)  # skewed scales
    W_true = rng.standard_normal((n_features, n_targets)).astype(np.float32)
    Y = X @ W_true + 0.1 * rng.standard_normal(
        (n_samples, n_targets)).astype(np.float32)
    return X, Y, W_true


def lstsq(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The least-squares solution as the reference's ``jnp.linalg.lstsq``
    takes it: an SVD solve that drops the singular values below eps *
    max(m, n) of the largest (torch's default CPU driver, gelsy, cuts the
    rank of the default X far more)."""
    rtol = torch.finfo(X.dtype).eps * max(X.shape)
    return (torch.linalg.pinv(X, rtol=rtol) @ Y).contiguous()


def run(n_samples: int = 4096, n_features: int = 1024, n_targets: int = 51,
        *, device=None, picks: torch.Tensor | None = None) -> dict:
    """Print the three solves' relative residuals and the downstream
    error; return the results (``sync``, ``async``, ``cg``), ``W_cg``,
    ``beta`` and ``rel_w``."""
    dev = resolve_device(device)
    X, Y, W_true = (torch.from_numpy(a).to(dev)
                    for a in build_problem(n_samples, n_features, n_targets))
    m, n = X.shape
    k = Y.shape[1]
    W_star = lstsq(X, Y)
    yn = float(torch.linalg.norm(Y))
    floor = float(torch.linalg.norm(Y - X @ W_star)) / yn
    s = torch.linalg.svdvals(X)
    # package as an LSQProblem so the unified solve() front door applies
    prob = LSQProblem(A=X, b=Y, x_star=W_star, x_true=W_true,
                      sigma_min=s[-1], sigma_max=s[0])
    print(f"least squares: m={m}, n={n}, targets={k}, "
          f"kappa(X)={float(s[0] / s[-1]):.1f}, optimum relresid={floor:.3e}")

    def seeded(seed):
        return torch.Generator(dev).manual_seed(seed)

    def rows():
        return ({"picks": picks} if picks is not None
                else {"generator": seeded(0)})

    wait(dev)
    t0 = time.perf_counter()
    res = solve(prob, **rows(),
                schedule=Schedule(num_iters=SWEEPS * m, record_every=m))
    wait(dev)
    t_rk = time.perf_counter() - t0

    # Async RK with the Thm-analogous step size beta~ = 1/(1 + 2 rho_rk tau).
    rho_rk = float(theory.rk_rho(X))
    beta = theory.beta_opt_rk(rho_rk, TAU)
    ares = solve(prob, **rows(), beta=beta, delay_generator=seeded(1),
                 schedule=Schedule(num_iters=SWEEPS * m, tau=TAU,
                                   record_every=m))

    # Baseline: CG on the Jacobi-rescaled normal equations (Sec. 2.3):
    # kappa is still squared relative to X and every iteration costs two
    # global reductions.
    B, d = to_unit_diagonal(X.T @ X)
    z = d[:, None] * (X.T @ Y)
    cg = cg_solve(B, z, torch.zeros_like(W_star), W_star / d[:, None],
                  num_iters=SWEEPS)
    W_cg = d[:, None] * cg.x

    print(f"after {SWEEPS} sweeps / NE iterations "
          f"(equal O(mn) work per sweep/iteration):")
    print(f"  sync RK    relresid "
          f"{float(torch.linalg.norm(res.resid[-1])) / yn:.3e} ({t_rk:.1f}s)")
    print(f"  async RK   relresid "
          f"{float(torch.linalg.norm(ares.resid[-1])) / yn:.3e} "
          f"(tau={TAU}, beta~={beta:.2f})")
    print(f"  CG (X^T X) relresid "
          f"{float(torch.linalg.norm(Y - X @ W_cg)) / yn:.3e}")

    # the downstream metric the paper cares about: regression quality
    rel_w = float(torch.linalg.norm(ares.x - W_true)
                  / torch.linalg.norm(W_true))
    print(f"  downstream: ||W_hat - W_true||/||W_true|| = {rel_w:.3f} "
          f"(low-accuracy regime is enough, as in the paper)")
    return {"sync": res, "async": ares, "cg": cg, "W_cg": W_cg,
            "beta": beta, "rel_w": rel_w, "floor": floor}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--features", type=int, default=1024)
    ap.add_argument("--targets", type=int, default=51)
    ap.add_argument("--device", default="cuda",
                    help="where the problem and the solves live (cuda "
                         "raises without a card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    return run(args.samples, args.features, args.targets,
               device=torch.device(args.device))


if __name__ == "__main__":
    main()
