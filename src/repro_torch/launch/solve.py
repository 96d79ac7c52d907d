"""Solver launcher — the paper's algorithm as a CLI (port of
``repro/launch/solve.py``).

``python -m repro_torch.launch.solve --n 4096 --rhs 8 --sweeps 10`` builds
a reference-scenario SPD system on ``--device`` (the card by default;
``cpu`` only when asked) and solves it through
``repro_torch.solve(problem, format=..., schedule=...)``: (a) sequential
randomized Gauss-Seidel, (b) asynchronous randomized Gauss-Seidel on
``--workers`` ranks (the distributed engine, ``--local-steps`` updates a
rank between synchronizations, ``--sync`` the exchange, the step size
beta~ for its staleness ``scheduled_tau(--workers, --local-steps)``), (c)
CG, printing residuals and the paper's theoretical rate factors.
``--format ell`` runs both GS passes through the ELL operator and
``--format csr`` through CSR (one sweep-kernel launch per sweep, or per
round and rank, on the card).

The distributed pass runs on a gloo process group: at ``--workers 1`` in
this process, above it in ``--workers`` spawned processes
(``launch.mesh.run_workers``) that share the device (NCCL needs a card per
rank).  ``--partition``, ``--overlap`` and ``--compress`` set its
``Schedule``; with ``--overlap`` a ``staleness`` line prints the measured
lag.  The reference's ``--fused`` is gone: the port has one engine.  The sequential stream is a
``torch.Generator`` seeded 1 and the distributed one seed 2 (each rank's
``2 * P + rank``), not the reference's ``jax.random.key(1)`` and
``key(2)``, so residuals differ from the reference CLI's.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.core import (Schedule, cg_solve, random_sparse_spd, solve,
                              theory)
from repro_torch.core.engine import (COMPRESS_MODES, PARTITIONS,
                                     scheduled_tau)
from repro_torch.core.operators import STORAGE_DTYPES
from repro_torch.launch.mesh import process_group, run_workers

#: the --format flag values, shared with the serve launcher so the two
#: CLIs' choices cannot drift
FORMAT_CHOICES = ("dense", "ell", "csr")
SYNC_CHOICES = ("auto", "allgather", "a2a", "halo")


def wait(device: torch.device) -> None:
    """Let the card finish its queued work, so a pass's wall time is
    whole."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_workers(device: torch.device) -> int:
    """``--workers 0``: one worker per local device (CUDA devices on the
    card, one on the CPU)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def distributed_pass(group, device, prob, job):
    """The distributed solve of one rank (``job``: ``solve``'s keywords
    under "solve", its ``Schedule``'s under "schedule"); returns its result
    and the rank's wall seconds (the operator's build included)."""
    wait(device)
    t0 = time.perf_counter()
    res = solve(prob, group=group, **job["solve"],
                schedule=Schedule(**job["schedule"]))
    wait(device)
    return res, time.perf_counter() - t0


def _rank(group, device, path, job):
    """A spawned rank: the problem from the parent's file, then its pass."""
    prob = torch.load(path, weights_only=False)
    prob = prob._replace(**{f: getattr(prob, f).to(device)
                            for f in prob._fields})
    return distributed_pass(group, device, prob, job)


def print_staleness(res, tau_lockstep: int, tau: int) -> None:
    """The measured lag of an overlapped pass against its bound."""
    if res.lag is None:
        return
    top = int(res.lag.max())
    print(f"  staleness  : measured lag max={top} (round 1: "
          f"{int(res.lag[0])}) -> empirical tau {top + tau_lockstep} <= "
          f"scheduled bound {tau}")


def run_distributed(prob, job, workers: int, device: torch.device):
    """``distributed_pass`` on ``workers`` gloo ranks: this process alone
    at one, else that many spawned processes sharing ``device``; rank 0's
    result and wall seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        if workers == 1:
            with process_group("gloo", tmp) as group:
                return distributed_pass(group, device, prob, job)
        path = str(Path(tmp) / "problem.pt")
        torch.save(prob._replace(**{f: getattr(prob, f).cpu()
                                    for f in prob._fields}), path)
        return run_workers(_rank, workers, path, job, backend="gloo",
                           device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--rhs", type=int, default=8)
    ap.add_argument("--row-nnz", type=int, default=16)
    ap.add_argument("--offdiag", type=float, default=0.9)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--format", choices=FORMAT_CHOICES, default="dense",
                    help="operator format of the sequential pass")
    ap.add_argument("--ell-width", type=int, default=64)
    ap.add_argument("--sync", choices=SYNC_CHOICES, default="auto",
                    help="exchange of the distributed pass: a2a (the "
                         "sparsity-derived neighbor exchange) needs csr or "
                         "ell; halo belongs to the banded format, which this "
                         "CLI does not build")
    ap.add_argument("--partition", choices=PARTITIONS,
                    default="contiguous",
                    help="distributed slab assignment: 'balanced' bin-packs "
                         "rows by norm mass and nnz into the P slabs via a "
                         "symmetric row permutation (csr or ell)")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered sync: each round installs the "
                         "PREVIOUS round's exchange while sweeping, at the "
                         "cost of one extra round of scheduled staleness "
                         "(sparse strategies; dense falls back to lockstep "
                         "with a warning)")
    ap.add_argument("--storage-dtype", choices=STORAGE_DTYPES, default=None,
                    help="precision the operator's coefficients are stored "
                         "in (row norms, iterate and accumulation stay "
                         "f32); default keeps the input dtype bitwise")
    ap.add_argument("--compress", choices=COMPRESS_MODES, default="none",
                    help="wire format of the distributed sync payload; the "
                         "GS all-gather and a2a exchanges have no "
                         "compressed wire, so a value other than 'none' "
                         "falls back to the exact exchange with a warning")
    ap.add_argument("--workers", type=int, default=0,
                    help="ranks of the distributed pass (0 = all local "
                         "devices); above the device count they share one")
    ap.add_argument("--local-steps", type=int, default=0,
                    help="async steps between synchronizations "
                         "(0 -> one sweep split evenly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the problem and the solves live (cuda "
                         "raises without a card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.sync == "a2a" and args.format == "dense":
        ap.error("--sync a2a needs a sparse format (--format csr or ell)")
    if args.sync == "halo":
        ap.error("--sync halo needs the banded format, which this CLI does "
                 "not build")
    if args.partition == "balanced" and args.format == "dense":
        ap.error("--partition balanced needs a sparse format "
                 "(--format csr or ell)")
    device = torch.device(args.device)

    prob = random_sparse_spd(args.n, row_nnz=args.row_nnz,
                             offdiag=args.offdiag, n_rhs=args.rhs,
                             seed=args.seed, device=device)
    if args.format == "ell":
        # A width below the largest row occupancy silently solves a
        # truncated system; widen to keep the ELL operator exact.
        max_nnz = int((prob.A != 0).sum(1).max())
        if args.ell_width < max_nnz:
            print(f"  [warn] --ell-width {args.ell_width} < max nnz/row "
                  f"{max_nnz}; widening to keep the operator exact")
            args.ell_width = max_nnz
    x0 = torch.zeros_like(prob.x_star)
    rho = float(theory.rho(prob.A))
    n = prob.n
    kappa = float(prob.kappa)
    print(f"[solve] n={n} rhs={args.rhs} kappa={kappa:.1f} rho={rho:.4f} "
          f"format={args.format}")

    iters = args.sweeps * n
    wait(device)
    t0 = time.perf_counter()
    res = solve(prob, generator=torch.Generator(device).manual_seed(1),
                format=args.format, width=args.ell_width,
                storage_dtype=args.storage_dtype,
                schedule=Schedule(num_iters=iters, record_every=n))
    wait(device)
    print(f"  sync RGS   : {args.sweeps} sweeps, resid "
          f"{float(res.resid[-1, 0]):.3e} ({time.perf_counter() - t0:.3f}s)")

    workers = args.workers or default_workers(device)
    local_steps = args.local_steps or max(1, n // workers)
    tau = scheduled_tau(workers, local_steps, overlap=args.overlap)
    beta = theory.beta_opt(rho, tau)
    rounds = max(1, iters // (workers * local_steps))
    job = dict(
        solve=dict(beta=beta, format=args.format, width=args.ell_width,
                   storage_dtype=args.storage_dtype, sync=args.sync, seed=2),
        schedule=dict(rounds=rounds, local_steps=local_steps,
                      partition=args.partition, overlap=args.overlap,
                      compress=args.compress))
    pres, secs = run_distributed(prob, job, workers, device)
    print(f"  async RGS  : P={workers} tau={tau} beta~={beta:.3f} "
          f"format={args.format} sync={args.sync} "
          f"({pres.bytes_per_round:.0f} B/round) {rounds} rounds, resid "
          f"{float(pres.resid[-1, 0]):.3e} ({secs:.3f}s) "
          f"partition={args.partition} overlap={args.overlap} "
          f"compress={args.compress}")
    print_staleness(pres, scheduled_tau(workers, local_steps), tau)

    wait(device)
    t0 = time.perf_counter()
    cres = cg_solve(prob.A, prob.b, x0, prob.x_star, num_iters=args.sweeps)
    wait(device)
    print(f"  CG         : {args.sweeps} iters, resid "
          f"{float(cres.resid[-1, 0]):.3e} ({time.perf_counter() - t0:.3f}s)")

    nu = theory.nu_tau(rho, tau, beta)
    print(f"  theory     : P={workers} tau={tau} beta~={beta:.3f} "
          f"nu_tau(beta~)={nu:.3f} epoch factor <= "
          f"{theory.thm41a_factor(rho, tau, kappa, beta):.5f}")
    return {"problem": prob, "sync": res, "async": pres, "cg": cres,
            "rho": rho, "tau": tau, "beta": beta, "async_s": secs}


if __name__ == "__main__":
    main()
