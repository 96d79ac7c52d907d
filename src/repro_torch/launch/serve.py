"""Solver-as-a-service launcher (port of ``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --n 256 --requests 16 --rate 50``
builds a reference-scenario problem on ``--device`` (the card by default;
``cpu`` only when asked), registers it with a persistent
``SolverService`` and drives the service with a synthetic open-loop
request stream of mixed RHS widths, printing queries/sec, p50/p99
latency, convergence and the continuous-batching counters (batches,
chunk launches, expired deadlines).  ``--serial`` runs the same stream
one request per batch (``max_batch=1``), the baseline of the batched
numbers.  The reference's ``--fused`` is gone: the port has one engine.
"""
from __future__ import annotations

import argparse

from repro_torch.core import random_sparse_lsq, random_sparse_spd
from repro_torch.launch.solve import FORMAT_CHOICES
from repro_torch.serve import SolverService, open_loop_load


def build_service(args) -> tuple[SolverService, str]:
    """A service ready to start, with the CLI's problem registered."""
    svc = SolverService(
        num_iters=args.max_iters, record_every=args.record_every,
        max_batch=1 if args.serial else args.max_batch,
        batch_window_s=args.batch_window_ms * 1e-3)
    if args.action == "gs":
        prob = random_sparse_spd(args.n, row_nnz=args.row_nnz, n_rhs=1,
                                 seed=args.seed, device=args.device)
    else:
        prob = random_sparse_lsq(2 * args.n, args.n, row_nnz=args.row_nnz,
                                 n_rhs=1, seed=args.seed, device=args.device)
    svc.register("default", prob.A, action=args.action, format=args.format,
                 seed=args.seed, warmup_buckets=(1,) if args.warmup else ())
    return svc, "default"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--row-nnz", type=int, default=8)
    ap.add_argument("--action", choices=("gs", "rk"), default="gs",
                    help="gs = SPD coordinate action, rk = rectangular "
                         "Kaczmarz (the service batches either)")
    ap.add_argument("--format", choices=FORMAT_CHOICES, default="csr")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="open-loop arrival rate (requests/sec)")
    ap.add_argument("--rhs-widths", type=int, nargs="+", default=[1, 2, 4],
                    help="request RHS widths drawn uniformly (mixed shapes "
                         "exercise the bucketer)")
    ap.add_argument("--rtol", type=float, default=1e-3)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--max-iters", type=int, default=4096)
    ap.add_argument("--record-every", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--serial", action="store_true",
                    help="one-request-at-a-time baseline (max_batch=1)")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the problem and the solves live (cuda "
                         "raises without a card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    svc, name = build_service(args)
    with svc:
        report = open_loop_load(
            svc, name, requests=args.requests, rate_hz=args.rate,
            rhs_widths=tuple(args.rhs_widths), rtol=args.rtol,
            seed=args.seed,
            deadline_s=(None if args.deadline_ms is None
                        else args.deadline_ms * 1e-3))

    mode = "serial" if args.serial else "batched"
    print(f"[serve] mode={mode} requests={report.requests} "
          f"converged={report.converged} qps={report.qps:.1f} "
          f"p50={report.p50_ms:.1f}ms p99={report.p99_ms:.1f}ms "
          f"makespan={report.makespan_s:.2f}s")
    print(f"[serve] batches={svc.stats.batches} "
          f"chunk_launches={svc.stats.chunk_launches} "
          f"deadline_expired={svc.stats.deadline_expired}")
    return {"report": report._asdict(), "stats": svc.stats}


if __name__ == "__main__":
    main()
