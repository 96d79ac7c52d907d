"""Paper Figure 2 analogue: scaling of Asynchronous Randomized Gauss-Seidel
with worker count (10 sweeps' wall time, speedup vs 1 worker); the
counterpart of the reference's ``benchmarks/fig2_scaling.py``.

    python -m repro_torch.paper.fig2_scaling [--device cpu]

Each worker count P runs ``parallel_rgs_solve`` (the dense all-gather
strategy, one ``block_gs_sweep`` launch a round and rank on the card) on P
ranks of a gloo process group: this process alone at P = 1, else P
processes started by ``launch.mesh.run_workers``, where the reference
forces P host devices in a subprocess.  The P processes share one card
(NCCL needs a card a rank), so *wall-clock* speedups are not observable:
the driver reports the per-worker iteration counts, the synchronization
rounds and each round's all-gather wire bytes (the ring model,
``roofline.ring_wire_bytes``; the quantities that scale), plus wall time
for completeness.

Each rank's directions come from ``seed=0`` (rank r's generator seeded
``0 * P + r``; the reference's ``jax.random.key(0)``, another stream), or
from ``picks=`` (``picks[P]``: ``(rounds, P, local_steps)`` slab-local
ids; the warm-up round takes its first round).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.core import parallel_rgs_solve, random_sparse_spd, theory
from repro_torch.launch.mesh import process_group, run_workers
from repro_torch.launch.solve import wait
from repro_torch.paper.common import emit
from repro_torch.roofline import ring_wire_bytes


def _solve_rank(group, device, prob, job) -> dict:
    """One rank's run: a warm-up round, then ``job["rounds"]`` timed
    rounds; rank 0's wall seconds and relative residual, and whether x is
    finite on every rank."""
    x0 = torch.zeros_like(prob.x_star)
    picks = job["picks"]
    kw = dict(group=group, local_steps=job["local_steps"], beta=job["beta"])
    parallel_rgs_solve(prob.A, prob.b, x0, prob.x_star, rounds=1,
                       **kw, **({"seed": 0} if picks is None
                                else {"picks": picks[:1]}))
    wait(device)
    t0 = time.perf_counter()
    r = parallel_rgs_solve(prob.A, prob.b, x0, prob.x_star,
                           rounds=job["rounds"], **kw,
                           **({"seed": 0} if picks is None
                              else {"picks": picks}))
    wait(device)
    wall = time.perf_counter() - t0
    finite = torch.isfinite(r.x).all().to(torch.float32).reshape(1)
    dist.all_reduce(finite, op=dist.ReduceOp.MIN, group=group)
    return dict(wall_s=wall, x_finite=bool(finite.item()),
                resid=float(torch.linalg.norm(r.resid[-1])
                            / torch.linalg.norm(prob.b)))


def _rank(group, device, path, job):
    """A spawned rank: the problem from the parent's file, then its run."""
    prob = torch.load(path, weights_only=False)
    prob = prob._replace(**{f: getattr(prob, f).to(device)
                            for f in prob._fields})
    return _solve_rank(group, device, prob, job)


def run(n: int = 1024, sweeps: int = 10, workers=(1, 2, 4, 8), *,
        device=None, problem=None, picks: dict | None = None) -> list:
    """A line for each worker count and the derived lines; return the
    records (a dict each: P, tau, beta, wall_s, resid, iters_per_worker,
    sync_rounds, ring_wire_bytes, x_finite).  ``problem`` replaces
    ``random_sparse_spd(n, row_nnz=16, offdiag=0.95, n_rhs=4, seed=0)``."""
    prob = problem or random_sparse_spd(n, row_nnz=16, offdiag=0.95,
                                        n_rhs=4, seed=0, device=device)
    device, n = prob.A.device, prob.n
    rho = float(theory.rho(prob.A))
    gathered = prob.x_star.numel() * prob.x_star.element_size()
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "problem.pt")
        torch.save(prob._replace(**{f: getattr(prob, f).cpu()
                                    for f in prob._fields}), path)
        for P in workers:
            local = n // P
            tau = (P - 1) * local
            beta = theory.beta_opt(rho, tau)
            job = dict(rounds=sweeps, local_steps=local, beta=beta,
                       picks=None if picks is None else picks[P])
            try:
                if P == 1:
                    with tempfile.TemporaryDirectory() as store, \
                            process_group("gloo", store) as group:
                        out = _solve_rank(group, device, prob, job)
                else:
                    out = run_workers(_rank, P, path, job, backend="gloo",
                                      device=device)
            except (RuntimeError, TimeoutError) as e:
                emit("fig2_scaling", P=P, error=str(e).strip()[-200:])
                continue
            rec = dict(P=P, tau=tau, beta=beta, wall_s=out["wall_s"],
                       resid=out["resid"], iters_per_worker=sweeps * local,
                       sync_rounds=sweeps,
                       ring_wire_bytes=ring_wire_bytes("all-gather",
                                                       gathered, P),
                       x_finite=out["x_finite"])
            results.append(rec)
            emit("fig2_scaling", P=rec["P"], tau=rec["tau"],
                 beta=f"{rec['beta']:.3f}", wall_s=f"{rec['wall_s']:.2f}",
                 resid_10sweeps=f"{rec['resid']:.3e}",
                 iters_per_worker=rec["iters_per_worker"],
                 sync_rounds=rec["sync_rounds"],
                 ring_wire_bytes=f"{rec['ring_wire_bytes']:.0f}")
    if results:
        base = results[0]
        for rec in results:
            speedup = base["iters_per_worker"] / rec["iters_per_worker"]
            ratio = rec["resid"] / max(base["resid"], 1e-30)
            emit("fig2_scaling_derived", P=rec["P"],
                 work_speedup=f"{speedup:.2f}",
                 resid_ratio_vs_P1=f"{ratio:.2f}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    run(device=torch.device(ap.parse_args().device))
