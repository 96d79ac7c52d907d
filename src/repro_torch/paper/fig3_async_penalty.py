"""Paper Figure 3 analogue: relative residual after 10 sweeps, synchronous
RGS vs asynchronous RGS at increasing staleness, with min/max over trials
(the paper runs 5 extra trials at 64 threads and reports the spread); the
counterpart of the reference's ``benchmarks/fig3_async_penalty.py``.

    python -m repro_torch.paper.fig3_async_penalty [--device cpu]

The paper's claim to reproduce: the asynchronous residual is slightly worse
but the same order of magnitude, and the spread across schedules is small.
Both read models are measured through the bounded-delay simulator; one
fixed direction stream serves every variant, as the paper's Random123
trick does (same d_j across all variants).  It comes from a
``torch.Generator`` seeded 42, trial t's delays from one seeded 100 + t
(the reference's keys' integers, another stream; ``streams`` draws them),
or from ``picks=`` and ``delays=`` (``delays[(tau, model)]`` a tensor a
trial).  ``--draw-device`` builds the default problem (its x* is drawn
on the device too) and draws the default streams on another device than
``--device``, then runs on them there, so the card and the CPU can be
held to each other on the same problem and streams.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (async_rgs_solve, random_sparse_spd, rgs_solve,
                              theory)
from repro_torch.core.engine import draw_delays
from repro_torch.paper.common import emit

READ_MODELS = ("consistent", "inconsistent")
N, SWEEPS, TAUS, TRIALS = 1024, 10, (4, 16, 64), 5
# each read model's delays: consistent reads s_j ~ U{0..tau}, inconsistent
# reads each of the last tau updates missed with probability MISS_PROB
DELAY_MODES = {"consistent": "uniform", "inconsistent": "fixed"}
MISS_PROB = 0.5


def step_size(model: str, tau: int, rho: float, rho2: float) -> float:
    """beta of a variant: 1 where the consistent-read rate needs no cut
    (2 rho tau < 1), else beta~ of its read model."""
    if model == "inconsistent":
        return theory.beta_opt_inconsistent(rho2, tau)
    if 2 * rho * tau >= 1:
        return theory.beta_opt(rho, tau)
    return 1.0


def default_problem(n: int = N, device=None):
    """The reference's problem: ``random_sparse_spd(n, row_nnz=16,
    offdiag=0.95, n_rhs=4, seed=0)``, with x* and b drawn on ``device``."""
    return random_sparse_spd(n, row_nnz=16, offdiag=0.95, n_rhs=4, seed=0,
                             device=device)


def streams(n: int, iters: int, taus, trials: int,
            device) -> tuple[torch.Tensor, dict]:
    """The default streams, drawn on ``device``: ``iters`` picks in
    [0, n) from a generator seeded 42, and ``delays[(tau, model)]``, trial
    t's delays from one seeded 100 + t."""
    def seeded(seed):
        return torch.Generator(device).manual_seed(seed)

    picks = torch.randint(0, n, (iters,), generator=seeded(42),
                          device=device)
    delays = {(tau, model): [draw_delays(
        iters, tau, read_model=model, delay_mode=DELAY_MODES[model],
        miss_prob=MISS_PROB, generator=seeded(100 + t))
        for t in range(trials)] for tau in taus for model in READ_MODELS}
    return picks, delays


def measure(n: int = N, sweeps: int = SWEEPS, taus=TAUS,
            trials: int = TRIALS, *, device=None, problem=None,
            picks: torch.Tensor | None = None,
            delays: dict | None = None) -> dict:
    """The sync residual and, for each tau and read model, beta and the
    trials' residuals (relative to ||b||); ``streams`` on the problem's
    device stands in for ``picks`` or ``delays`` not given.  ``problem``
    replaces ``default_problem(n)``."""
    prob = problem or default_problem(n, device)
    A, b, x_star = prob.A, prob.b, prob.x_star
    x0 = torch.zeros_like(x_star)
    b_norm = float(torch.linalg.norm(b))
    iters = sweeps * prob.n
    if picks is None or delays is None:
        drawn = streams(prob.n, iters, taus, trials, prob.A.device)
        picks = drawn[0] if picks is None else picks
        delays = drawn[1] if delays is None else delays

    def rel(res):
        return float(torch.linalg.norm(res.resid[-1])) / b_norm

    sync_r = rel(rgs_solve(A, b, x0, x_star, num_iters=iters, picks=picks))
    rho, rho2 = float(theory.rho(A)), float(theory.rho2(A))
    rows = []
    for tau in taus:
        for model in READ_MODELS:
            beta = step_size(model, tau, rho, rho2)
            rs = [rel(async_rgs_solve(
                A, b, x0, x_star, num_iters=iters, tau=tau, beta=beta,
                read_model=model, delay_mode=DELAY_MODES[model],
                picks=picks, delays=delays[(tau, model)][t]))
                for t in range(trials)]
            rows.append(dict(tau=tau, model=model, beta=beta, resids=rs,
                             penalty=float(np.mean(rs)) / sync_r))
    return {"sync": sync_r, "rows": rows}


def report(out: dict) -> None:
    """Print ``measure``'s numbers as the reference's lines."""
    emit("fig3_async_penalty", variant="sync", tau=0,
         resid=f"{out['sync']:.4e}")
    for row in out["rows"]:
        emit("fig3_async_penalty", variant=row["model"], tau=row["tau"],
             beta=f"{row['beta']:.3f}", resid_min=f"{min(row['resids']):.4e}",
             resid_max=f"{max(row['resids']):.4e}",
             penalty_vs_sync=f"{row['penalty']:.2f}x")


def run(n: int = N, sweeps: int = SWEEPS, taus=TAUS, trials: int = TRIALS,
        **kw) -> float:
    """Measure and print (``measure``'s keywords pass through); return the
    sync residual, as the reference does."""
    out = measure(n, sweeps, taus, trials, **kw)
    report(out)
    return out["sync"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    ap.add_argument("--draw-device", default=None,
                    help="build the default problem and draw the default "
                         "streams on this device (cpu or cuda), then run "
                         "them on --device")
    args = ap.parse_args()
    dev = torch.device(args.device)
    kw = {}
    if args.draw_device:
        drawn = torch.device(args.draw_device)
        prob = default_problem(N, drawn)
        picks, delays = streams(N, SWEEPS * N, TAUS, TRIALS, drawn)
        kw = dict(problem=prob._replace(**{f: getattr(prob, f).to(dev)
                                           for f in prob._fields}),
                  picks=picks.to(dev),
                  delays={key: [d.to(dev) for d in ds]
                          for key, ds in delays.items()})
    run(device=dev, **kw)
