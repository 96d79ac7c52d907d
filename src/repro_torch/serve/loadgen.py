"""Synthetic open-loop load generator for the serving layer (port of
``repro/serve/loadgen.py``: the same arrival plan for the same seed).

Open-loop means arrivals are scheduled from a fixed process (seeded
exponential inter-arrival gaps at ``rate_hz``), NOT gated on completions
— the honest way to measure a service's latency under load, because a
closed loop would slow the arrival rate down exactly when the service
struggles.  Requests draw mixed RHS widths from ``rhs_widths`` so the
bucketer and executor cache see realistic shape diversity.

Everything is host-side and deterministic given ``seed``; latency is
measured per request from submission to ticket completion (the service
stamps it), and throughput as completed requests over the span from first
submission to last completion.
"""
from __future__ import annotations

import random
import time
from typing import NamedTuple

import numpy as np


class LoadReport(NamedTuple):
    requests: int
    qps: float                # completed requests / makespan
    p50_ms: float
    p99_ms: float
    mean_ms: float
    makespan_s: float
    converged: int            # requests with every column converged
    rounds_per_request: list  # max record chunks any of a request's columns took
    latencies_ms: list


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an ascending list (q in [0, 100])."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def make_rhs(n: int, width: int, rng: np.random.Generator) -> np.ndarray:
    """A dense ``(n, width)`` Gaussian RHS block."""
    return rng.standard_normal((n, width)).astype(np.float32)


def open_loop_load(service, problem: str, *, requests: int, rate_hz: float,
                   rhs_widths=(1,), rtol: float = 1e-3, seed: int = 0,
                   deadline_s: float | None = None,
                   timeout_s: float = 300.0) -> LoadReport:
    """Drive ``service`` with an open-loop request stream; gather stats.
    The RHS blocks are numpy arrays; ``submit`` moves each to the
    operator's device."""
    reg = service._problems[problem]
    n = reg.op.shape[0]
    gaps = random.Random(seed)
    rng = np.random.default_rng(seed + 1)
    plan = [(make_rhs(n, gaps.choice(list(rhs_widths)), rng),
             gaps.expovariate(rate_hz)) for _ in range(requests)]

    tickets = []
    t_start = time.monotonic()
    for b, gap in plan:
        time.sleep(gap)
        tickets.append(service.submit(problem, b, rtol=rtol,
                                      deadline_s=deadline_s))
    results = [t.result(timeout=timeout_s) for t in tickets]
    makespan = time.monotonic() - t_start

    lat = sorted(float(r.latency_s) * 1e3 for r in results)
    return LoadReport(
        requests=requests,
        qps=requests / makespan,
        p50_ms=percentile(lat, 50),
        p99_ms=percentile(lat, 99),
        mean_ms=float(np.mean(lat)),
        makespan_s=makespan,
        converged=sum(bool(r.converged.all()) for r in results),
        rounds_per_request=[int(r.rounds.max()) for r in results],
        latencies_ms=lat,
    )
