"""Least-squares launcher — the paper's Sec. 7 algorithm as a CLI (port of
the sequential passes of ``repro/launch/lsq.py``).

``python -m repro_torch.launch.lsq --m 4096 --n 512 --rhs 8 --sweeps 6``
builds an overdetermined regression system on ``--device`` (the card by
default; ``cpu`` only when asked) and solves it four ways through
``repro_torch.solve(problem, schedule=...)``:
(a) sequential randomized Kaczmarz on the rows of A (no normal equations),
(b) the bounded-delay asynchronous variant with the theory step size
    (``Schedule(tau=...)`` routes to the engine's ring-buffer simulator,
    which densifies a CSR operator exactly and warns),
(c) the distributed variant on ``--workers`` ranks (row slabs; dense: one
    global row stream partitioned by owner, ``dense_rk``; csr: each rank
    samples its own slab, ``sparse_rk``), ``--local-steps`` updates a rank
    between delta sums, ``--rk-sync``, ``--partition``, ``--overlap`` and
    ``--compress`` as the engine takes them,
(d) CG on the Jacobi-rescaled normal equations A^T A x = A^T b — the
    baseline that squares the condition number.
``--format csr`` builds the sparse design (``random_sparse_lsq``) and runs
the sequential pass through the CSR sweep kernel; ``dense`` builds
``random_lsq``.  The distributed pass runs as ``launch.solve``'s does: at
one worker in this process, above it in spawned gloo processes that share
the device.

Work accounting: one RK "sweep" = m row updates = O(mn) flops, the same as
one CG-on-normal-equations iteration (two A matvecs), so per-sweep residual
comparisons are equal-work comparisons.

The reference's ``--fused`` is gone: the port has one engine.  The row and
delay streams are ``torch.Generator``s seeded 1 and 2, and the
distributed pass's seed 1, not the reference's ``jax.random`` keys, so
residuals differ from the reference CLI's.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (Schedule, cg_solve, random_lsq,
                              random_sparse_lsq, solve, theory,
                              to_unit_diagonal)
from repro_torch.core.engine import (COMPRESS_MODES, PARTITIONS,
                                     scheduled_tau, supported_syncs)
from repro_torch.core.operators import STORAGE_DTYPES
from repro_torch.launch.solve import (default_workers, print_staleness,
                                      run_distributed, wait)

#: operator class names this CLI can build (--format dense/csr); the
#: --rk-sync choices are derived from the dispatch table narrowed to these
_CLI_FORMATS = ("DenseOp", "CsrOp")


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
    ap.add_argument("--rk-sync",
                    choices=("auto", *supported_syncs("rk", _CLI_FORMATS)),
                    default="auto",
                    help="distributed RK delta sync: a2a = two-phase "
                         "exchange over the column-slab neighbor graph "
                         "(csr format; bitwise the psum, falls back to it "
                         "when the graph is dense)")
    ap.add_argument("--partition", choices=PARTITIONS, default="contiguous",
                    help="distributed slab assignment: 'balanced' bin-packs "
                         "rows by norm mass and nnz into the P slabs via a "
                         "row permutation (csr format), restoring the global "
                         "Strohmer-Vershynin row law under per-rank local "
                         "sampling")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered delta sync for the distributed "
                         "pass: install round r-1's deltas while sweeping "
                         "round r (csr format; dense falls back to lockstep "
                         "with a warning), at the cost of one extra round "
                         "of scheduled staleness")
    ap.add_argument("--storage-dtype", choices=STORAGE_DTYPES, default=None,
                    help="precision the operator's coefficients are stored "
                         "in (row norms, iterate and accumulation stay "
                         "f32); default keeps the input dtype bitwise")
    ap.add_argument("--compress", choices=COMPRESS_MODES, default="none",
                    help="wire format of the distributed RK delta sync "
                         "(csr format, psum wire; a2a falls back to psum "
                         "with a warning under compression)")
    ap.add_argument("--workers", type=int, default=0,
                    help="ranks of the distributed pass (0 = all local "
                         "devices); above the device count they share one")
    ap.add_argument("--local-steps", type=int, default=0,
                    help="updates between synchronizations (0 -> "
                         "m/workers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the problem and the solves live (cuda "
                         "raises without a card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.format != "csr":
        if args.rk_sync == "a2a":
            ap.error("--rk-sync a2a needs --format csr")
        if args.partition == "balanced":
            ap.error("--partition balanced needs --format csr")
        if args.compress != "none":
            ap.error("--compress needs --format csr (the dense delta psum "
                     "has no compressed wire)")
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

    workers = args.workers or default_workers(device)
    local_steps = args.local_steps or max(1, m // workers)
    # csr runs per-rank local sampling: every rank's step is a useful
    # update, so a round applies workers * local_steps row actions (the
    # equal-work accounting) and the staleness bound follows suit.
    local_sampling = args.format == "csr"
    upd_per_round = local_steps * (workers if local_sampling else 1)
    rounds = max(1, iters // upd_per_round)
    ptau = scheduled_tau(workers, local_steps, shared_stream=True,
                         local_sampling=local_sampling, overlap=args.overlap)
    pbeta = theory.beta_opt_rk(rho_rk, ptau)
    job = dict(
        solve=dict(beta=pbeta, format=args.format, sync=args.rk_sync,
                   storage_dtype=args.storage_dtype, seed=1),
        schedule=dict(rounds=rounds, local_steps=local_steps,
                      partition=args.partition, overlap=args.overlap,
                      compress=args.compress))
    pres, secs = run_distributed(prob, job, workers, device)
    sampling = "local" if local_sampling else "global-stream"
    print(f"  par RK     : P={workers} tau={ptau} beta~={pbeta:.3f} "
          f"sampling={sampling} sync={args.rk_sync} "
          f"partition={args.partition} overlap={args.overlap} "
          f"compress={args.compress} ({pres.bytes_per_round:.0f} B/round) "
          f"{rounds} rounds, relresid {relresid(pres.resid[-1]):.3e} "
          f"({secs:.3f}s)")
    print_staleness(pres, scheduled_tau(workers, local_steps,
                                        shared_stream=True,
                                        local_sampling=local_sampling),
                    ptau)

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
    return {"problem": prob, "seq": res, "async": ares, "par": pres,
            "cg": cres, "rho_rk": rho_rk, "beta": beta, "floor": floor,
            "par_tau": ptau, "par_beta": pbeta, "par_s": secs}


if __name__ == "__main__":
    main()
