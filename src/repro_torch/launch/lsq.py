"""Least-squares launcher — the paper's Sec. 7 algorithm as a CLI (port of
the sequential passes of ``repro/launch/lsq.py``).

``python -m repro_torch.launch.lsq --m 4096 --n 512 --rhs 8 --sweeps 6``
builds an overdetermined regression system on ``--device`` (the card by
default; ``cpu`` only when asked) and solves it three ways through
``repro_torch.solve(problem, schedule=...)``:
(a) sequential randomized Kaczmarz on the rows of A (no normal equations),
(b) the bounded-delay asynchronous variant with the theory step size
    (``Schedule(tau=...)`` routes to the engine's ring-buffer simulator,
    which densifies a CSR operator exactly and warns),
(c) CG on the Jacobi-rescaled normal equations A^T A x = A^T b — the
    baseline that squares the condition number.
``--format csr`` builds the sparse design (``random_sparse_lsq``) and runs
the sequential pass through the CSR sweep kernel; ``dense`` builds
``random_lsq``.

Work accounting: one RK "sweep" = m row updates = O(mn) flops, the same as
one CG-on-normal-equations iteration (two A matvecs), so per-sweep residual
comparisons are equal-work comparisons.

Not ported yet (ROADMAP queue 1 item 8): the reference's distributed pass
and its flags ``--rk-sync``, ``--partition``, ``--overlap``,
``--compress``, ``--workers`` and ``--local-steps``.  The reference's
``--fused`` is gone: the port has one engine.  The row and delay streams
are ``torch.Generator``s seeded 1 and 2, not the reference's
``jax.random`` keys, so residuals differ from the reference CLI's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (Schedule, cg_solve, random_lsq,
                              random_sparse_lsq, solve, theory,
                              to_unit_diagonal)
from repro_torch.core.operators import STORAGE_DTYPES
from repro_torch.launch.solve import wait


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--rhs", type=int, default=8)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--col-scale", type=float, default=0.5,
                    help="exponential column-scale skew (0 = isotropic)")
    ap.add_argument("--format", choices=("dense", "csr"), default="dense",
                    help="operator format; csr additionally switches the "
                         "design to the sparse reference scenario")
    ap.add_argument("--row-nnz", type=int, default=16,
                    help="nonzeros per row of the sparse design "
                         "(--format csr)")
    ap.add_argument("--sweeps", type=int, default=6)
    ap.add_argument("--tau", type=int, default=32,
                    help="delay bound for the async simulator")
    ap.add_argument("--storage-dtype", choices=STORAGE_DTYPES, default=None,
                    help="precision the operator's coefficients are stored "
                         "in (row norms, iterate and accumulation stay "
                         "f32); default keeps the input dtype bitwise")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the problem and the solves live (cuda "
                         "raises without a card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.format == "csr":
        prob = random_sparse_lsq(args.m, args.n, row_nnz=args.row_nnz,
                                 n_rhs=args.rhs, noise=args.noise,
                                 seed=args.seed, device=device)
    else:
        prob = random_lsq(args.m, args.n, n_rhs=args.rhs, noise=args.noise,
                          col_scale=args.col_scale, seed=args.seed,
                          device=device)
    m, n = prob.shape
    bn = float(torch.linalg.vector_norm(prob.b))
    # residual at the LSQ optimum: the floor every solver is chasing
    floor = float(torch.linalg.vector_norm(prob.b - prob.A @ prob.x_star)) / bn
    kappa = float(prob.kappa)
    print(f"[lsq] m={m} n={n} rhs={args.rhs} kappa(A)={kappa:.1f} "
          f"kappa(A^T A)={kappa**2:.1f} optimum relresid={floor:.3e}")

    def relresid(resid):
        return float(torch.linalg.vector_norm(resid)) / bn

    iters = args.sweeps * m
    wait(device)
    t0 = time.perf_counter()
    res = solve(prob, generator=torch.Generator(device).manual_seed(1),
                format=args.format, storage_dtype=args.storage_dtype,
                schedule=Schedule(num_iters=iters, record_every=m))
    wait(device)
    print(f"  seq RK     : {args.sweeps} sweeps, relresid "
          f"{relresid(res.resid[-1]):.3e} ({time.perf_counter() - t0:.3f}s)")

    wait(device)
    t0 = time.perf_counter()
    rho_rk = float(theory.rk_rho(prob.A))
    beta = theory.beta_opt_rk(rho_rk, args.tau)
    t_rho = time.perf_counter() - t0
    t0 = time.perf_counter()
    ares = solve(prob, generator=torch.Generator(device).manual_seed(1),
                 delay_generator=torch.Generator(device).manual_seed(2),
                 beta=beta, format=args.format,
                 storage_dtype=args.storage_dtype,
                 schedule=Schedule(num_iters=iters, tau=args.tau,
                                   record_every=m))
    wait(device)
    print(f"  async RK   : tau={args.tau} beta~={beta:.3f} relresid "
          f"{relresid(ares.resid[-1]):.3e} ({time.perf_counter() - t0:.3f}s; "
          f"rho_rk {t_rho:.3f}s)")

    # Baseline: CG on the Jacobi-rescaled normal equations (Sec. 2.3) —
    # kappa is still squared relative to A.
    wait(device)
    t0 = time.perf_counter()
    x0 = torch.zeros_like(prob.x_star)
    An, dn = to_unit_diagonal(prob.A.T @ prob.A)
    bn_eq = dn[:, None] * (prob.A.T @ prob.b)
    cres = cg_solve(An, bn_eq, x0, prob.x_star / dn[:, None],
                    num_iters=args.sweeps)
    x_cg = dn[:, None] * cres.x
    cg_rel = relresid(prob.b - prob.A @ x_cg)
    print(f"  CG (A^T A) : {args.sweeps} iters, relresid {cg_rel:.3e} "
          f"({time.perf_counter() - t0:.3f}s)")

    wait(device)
    t0 = time.perf_counter()
    f_sync = float(theory.rk_factor(prob.A))
    f_async = float(theory.async_rk_factor(prob.A, args.tau, beta,
                                           rho_rk=rho_rk))
    print(f"  theory     : rho_rk={rho_rk:.4f} per-iter factor "
          f"sync={f_sync:.6f} async(tau={args.tau})={f_async:.6f} "
          f"({time.perf_counter() - t0:.3f}s)")
    return {"problem": prob, "seq": res, "async": ares, "cg": cres,
            "rho_rk": rho_rk, "beta": beta, "floor": floor}


if __name__ == "__main__":
    main()
