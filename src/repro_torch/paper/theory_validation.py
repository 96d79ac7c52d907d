"""Theorem validation (the paper's analytical contribution, measured; the
counterpart of the reference's ``benchmarks/theory_validation.py``):

* Leventhal-Lewis rate (eq. 2) — measured E_m vs the bound;
* Thm 4.1(a) epoch factor under bounded-delay consistent reads;
* Sec. 5 step-size theory — nu_tau(beta) maximized at beta~;
* Thm 6.1 inconsistent-read convergence at omega-optimal beta.

    python -m repro_torch.paper.theory_validation [--device cpu]

The streams come from ``torch.Generator`` objects seeded with the
reference's integers (directions s, 10 + s, 3, 5; delays 50 + s, 4, 6):
another stream than its threefry keys.  ``picks=`` and ``delays=`` take
given streams instead, one tensor a solve, by part: ``picks["ll"]`` and
``picks["thm41a"]`` a tensor a seed, ``picks["stepsize"]`` one tensor for
the four step sizes, ``picks["thm61"]`` one; ``delays["thm41a"]`` a tensor
a seed and ``delays["thm61"]`` one (the step-size solves' fixed delays
draw nothing).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (a_norm_sq, async_rgs_solve, random_sparse_spd,
                              rgs_solve, theory)
from repro_torch.paper.common import emit

TAU = 8


def measure(n: int = 512, seeds: int = 8, *, device=None, problem=None,
            picks: dict | None = None, delays: dict | None = None) -> dict:
    """Every number the validation prints, unformatted.  ``problem``
    replaces ``random_sparse_spd(n, row_nnz=8, offdiag=0.9, n_rhs=1,
    seed=0)``."""
    prob = problem or random_sparse_spd(n, row_nnz=8, offdiag=0.9, n_rhs=1,
                                        seed=0, device=device)
    n = prob.n
    dev = prob.A.device
    picks, delays = picks or {}, delays or {}

    def seeded(seed):
        return torch.Generator(dev).manual_seed(seed)

    def streams(part, i, pick_seed, delay_seed=None):
        kw = ({"picks": picks[part][i]} if part in picks
              else {"generator": seeded(pick_seed)})
        if delay_seed is not None:
            kw.update({"delays": delays[part][i]} if part in delays
                      else {"delay_generator": seeded(delay_seed)})
        return kw

    A, b, x_star = prob.A, prob.b, prob.x_star
    x0 = torch.zeros_like(x_star)
    e0 = float(a_norm_sq(A, -x_star).max())
    lam_min, lam_max = float(prob.lam_min), float(prob.lam_max)
    kappa = float(prob.kappa)
    rho = float(theory.rho(A))
    out = {"e0": e0}

    # (1) synchronous rate vs eq. (2)
    m = 4 * n
    errs = [float(rgs_solve(A, b, x0, x_star, num_iters=m, record_every=m,
                            **streams("ll", s, s)).err_sq[-1].max())
            for s in range(seeds)]
    bound = float(theory.ll_bound(e0, m, lam_min, n))
    out["ll"] = dict(m=m, errs=errs, measured_mean=float(np.mean(errs)),
                     bound=bound,
                     satisfied=int(np.mean(errs) <= 1.5 * bound))

    # (2) Thm 4.1(a) epoch factor
    m = max(theory.epoch_len(lam_max, n), n)
    factor = theory.thm41a_factor(rho, TAU, kappa)
    errs = [float(async_rgs_solve(
        A, b, x0, x_star, num_iters=m, tau=TAU, delay_mode="uniform",
        **streams("thm41a", s, 10 + s, 50 + s)).err_sq[-1].max())
        for s in range(seeds)]
    measured = float(np.mean(errs)) / e0
    out["thm41a"] = dict(tau=TAU, epoch_iters=m, errs=errs,
                         nu_tau=theory.nu_tau(rho, TAU), factor_bound=factor,
                         measured=measured,
                         satisfied=int(measured <= factor * 1.2))

    # (3) step-size sweep around beta~ (Sec. 5)
    beta_star = theory.beta_opt(rho, TAU)
    m = 4 * n
    rows = []
    for beta in (0.25 * beta_star, 0.5 * beta_star, beta_star,
                 min(1.0, 1.5 * beta_star)):
        r = async_rgs_solve(A, b, x0, x_star, num_iters=m, tau=TAU,
                            beta=float(beta), delay_mode="fixed",
                            **streams("stepsize", 0, 3, 4))
        rows.append((float(beta), theory.nu_tau(rho, TAU, float(beta)),
                     float(r.err_sq[-1].max()) / e0))
    out["stepsize"] = dict(rows=rows, beta_opt=beta_star,
                           best_measured_beta=min(rows, key=lambda t: t[2])[0])

    # (4) Thm 6.1 inconsistent reads
    rho2 = float(theory.rho2(A))
    beta_i = theory.beta_opt_inconsistent(rho2, TAU)
    r = async_rgs_solve(A, b, x0, x_star, num_iters=8 * n, tau=TAU,
                        beta=beta_i, read_model="inconsistent",
                        **streams("thm61", 0, 5, 6))
    err = float(r.err_sq[-1].max())
    out["thm61"] = dict(tau=TAU, beta=beta_i,
                        omega=theory.omega_tau(rho2, TAU, beta_i),
                        err_ratio_8n=err / e0, converged=int(err < 0.05 * e0))
    return out


def report(out: dict) -> None:
    """Print ``measure``'s numbers as the reference's lines."""
    ll, t41, ss, t61 = (out[p] for p in ("ll", "thm41a", "stepsize",
                                         "thm61"))
    emit("theory_ll_rate", m=ll["m"],
         measured_mean=f"{ll['measured_mean']:.3e}",
         bound=f"{ll['bound']:.3e}", satisfied=ll["satisfied"])
    emit("theory_thm41a", tau=t41["tau"], epoch_iters=t41["epoch_iters"],
         nu_tau=f"{t41['nu_tau']:.4f}",
         factor_bound=f"{t41['factor_bound']:.5f}",
         measured=f"{t41['measured']:.5f}", satisfied=t41["satisfied"])
    for beta, nu, ratio in ss["rows"]:
        emit("theory_stepsize", beta=f"{beta:.3f}", nu=f"{nu:.4f}",
             err_ratio=f"{ratio:.3e}")
    emit("theory_stepsize", beta_opt=f"{ss['beta_opt']:.3f}",
         best_measured_beta=f"{ss['best_measured_beta']:.3f}")
    emit("theory_thm61", tau=t61["tau"], beta=f"{t61['beta']:.3f}",
         omega=f"{t61['omega']:.4f}",
         err_ratio_8n=f"{t61['err_ratio_8n']:.3e}",
         converged=t61["converged"])


def run(n: int = 512, seeds: int = 8, **kw) -> None:
    """Measure and print (``measure``'s keywords pass through)."""
    report(measure(n, seeds, **kw))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    run(device=torch.device(ap.parse_args().device))
