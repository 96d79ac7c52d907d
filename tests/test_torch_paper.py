"""The port's paper drivers (``repro_torch.paper``) against the same calls
made into the reference's ``repro.core``, at small sizes on the CPU.

Each driver gets the reference's problem (its ``x_star`` and ``b`` come
from ``jax.random``) and the reference's streams: the direction picks
``randint(key, (iters,), 0, n)`` and the delays ``randint(delay_key,
(iters,), 0, tau + 1)`` (uniform) or ``bernoulli(delay_key, 0.5, (iters,
tau))`` (inconsistent reads) for the keys the reference scripts use.  The
reference side is the script's own arithmetic, written out here (the
tests do not import ``benchmarks/``).  Tolerances: the records within rtol
1e-4 (CG's also within 1e-6·||b|| absolute, for its f32 floor); beta, rho,
kappa and the theorem bounds within 1e-5; every 0/1 flag equal.  The
printed lines carry the reference's fields in its order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import (a_norm_sq as ref_a_norm_sq,  # noqa: E402
                        async_rgs_solve as ref_async_rgs_solve,
                        cg_solve as ref_cg_solve,
                        random_sparse_spd as ref_random_sparse_spd,
                        rgs_solve as ref_rgs_solve, theory as ref_theory)
from repro_torch import convert  # noqa: E402
from repro_torch.paper import (fig1_residual, fig3_async_penalty,  # noqa: E402
                               run as paper_run, theory_validation)

RTOL, CONST = 1e-4, 1e-5


def _port(r):
    return convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                          r.lam_max, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _picks(seed, iters, n):
    return _t(jax.random.randint(jax.random.key(seed), (iters,), 0, n))


def _uniform(seed, iters, tau):
    return _t(jax.random.randint(jax.random.key(seed), (iters,), 0, tau + 1))


def _misses(seed, iters, tau):
    return _t(jax.random.bernoulli(jax.random.key(seed), 0.5, (iters, tau)))


def _lines(text, name):
    """The printed records of ``name``: a list of (key, value) lists."""
    out = []
    for line in text.splitlines():
        head, _, rest = line.partition(",")
        if head == name:
            out.append([tuple(kv.split("=", 1)) for kv in rest.split(",")])
    return out


def _keys(rec):
    return [k for k, _ in rec]


def _close(got, want, rtol=CONST, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# theory_validation, n = 64, two seeds
# ---------------------------------------------------------------------------

TV_N, TV_SEEDS, TV_TAU = 64, 2, 8


@pytest.fixture(scope="module")
def theory_run():
    r = ref_random_sparse_spd(TV_N, row_nnz=8, offdiag=0.9, n_rhs=1, seed=0)
    n, tau = TV_N, TV_TAU
    m41 = max(ref_theory.epoch_len(float(r.lam_max), n), n)
    picks = {"ll": [_picks(s, 4 * n, n) for s in range(TV_SEEDS)],
             "thm41a": [_picks(10 + s, m41, n) for s in range(TV_SEEDS)],
             "stepsize": [_picks(3, 4 * n, n)],
             "thm61": [_picks(5, 8 * n, n)]}
    delays = {"thm41a": [_uniform(50 + s, m41, tau)
                         for s in range(TV_SEEDS)],
              "thm61": [_misses(6, 8 * n, tau)]}
    got = theory_validation.measure(TV_N, TV_SEEDS, problem=_port(r),
                                    picks=picks, delays=delays)
    return r, got


def _reference_theory(r):
    """theory_validation.py's arithmetic on the reference."""
    n, seeds, tau = TV_N, TV_SEEDS, TV_TAU
    x0 = jnp.zeros_like(r.x_star)
    e0 = float(ref_a_norm_sq(r.A, -r.x_star).max())
    lam_min, lam_max, kappa = (float(r.lam_min), float(r.lam_max),
                               float(r.kappa))
    rho = float(ref_theory.rho(r.A))
    out = {"e0": e0}
    m = 4 * n
    errs = [float(ref_rgs_solve(r.A, r.b, x0, r.x_star,
                                key=jax.random.key(s), num_iters=m,
                                record_every=m).err_sq[-1].max())
            for s in range(seeds)]
    bound = float(ref_theory.ll_bound(e0, m, lam_min, n))
    out["ll"] = dict(m=m, errs=errs, bound=bound,
                     satisfied=int(np.mean(errs) <= 1.5 * bound))
    m = max(ref_theory.epoch_len(lam_max, n), n)
    factor = ref_theory.thm41a_factor(rho, tau, kappa)
    errs = [float(ref_async_rgs_solve(
        r.A, r.b, x0, r.x_star, key=jax.random.key(10 + s),
        delay_key=jax.random.key(50 + s), num_iters=m, tau=tau,
        delay_mode="uniform").err_sq[-1].max()) for s in range(seeds)]
    out["thm41a"] = dict(epoch_iters=m, errs=errs, factor_bound=factor,
                         nu_tau=ref_theory.nu_tau(rho, tau),
                         satisfied=int(np.mean(errs) / e0 <= factor * 1.2))
    beta_star = ref_theory.beta_opt(rho, tau)
    rows = []
    for beta in (0.25 * beta_star, 0.5 * beta_star, beta_star,
                 min(1.0, 1.5 * beta_star)):
        res = ref_async_rgs_solve(r.A, r.b, x0, r.x_star,
                                  key=jax.random.key(3),
                                  delay_key=jax.random.key(4),
                                  num_iters=4 * n, tau=tau,
                                  beta=float(beta), delay_mode="fixed")
        rows.append((float(beta),
                     ref_theory.nu_tau(rho, tau, float(beta)),
                     float(res.err_sq[-1].max()) / e0))
    out["stepsize"] = dict(rows=rows, beta_opt=beta_star)
    rho2 = float(ref_theory.rho2(r.A))
    beta_i = ref_theory.beta_opt_inconsistent(rho2, tau)
    res = ref_async_rgs_solve(r.A, r.b, x0, r.x_star, key=jax.random.key(5),
                              delay_key=jax.random.key(6), num_iters=8 * n,
                              tau=tau, beta=beta_i,
                              read_model="inconsistent")
    err = float(res.err_sq[-1].max())
    out["thm61"] = dict(beta=beta_i,
                        omega=ref_theory.omega_tau(rho2, tau, beta_i),
                        err_ratio_8n=err / e0,
                        converged=int(err < 0.05 * e0))
    return out


def test_theory_validation_matches_the_reference(theory_run):
    r, got = theory_run
    want = _reference_theory(r)
    _close(got["e0"], want["e0"])
    _close(got["ll"]["errs"], want["ll"]["errs"], RTOL)
    _close(got["ll"]["bound"], want["ll"]["bound"])
    assert got["ll"]["m"] == want["ll"]["m"]
    assert got["ll"]["satisfied"] == want["ll"]["satisfied"]
    for f in ("nu_tau", "factor_bound"):
        _close(got["thm41a"][f], want["thm41a"][f])
    assert got["thm41a"]["epoch_iters"] == want["thm41a"]["epoch_iters"]
    _close(got["thm41a"]["errs"], want["thm41a"]["errs"], RTOL)
    assert got["thm41a"]["satisfied"] == want["thm41a"]["satisfied"]
    g_rows, w_rows = got["stepsize"]["rows"], want["stepsize"]["rows"]
    _close([r_[:2] for r_ in g_rows], [r_[:2] for r_ in w_rows])
    _close([r_[2] for r_ in g_rows], [r_[2] for r_ in w_rows], RTOL)
    _close(got["stepsize"]["beta_opt"], want["stepsize"]["beta_opt"])
    for f in ("beta", "omega"):
        _close(got["thm61"][f], want["thm61"][f])
    _close(got["thm61"]["err_ratio_8n"], want["thm61"]["err_ratio_8n"], RTOL)
    assert got["thm61"]["converged"] == want["thm61"]["converged"]


def test_theory_validation_prints_the_reference_fields(theory_run, capsys):
    _, got = theory_run
    theory_validation.report(got)
    text = capsys.readouterr().out
    assert [_keys(x) for x in _lines(text, "theory_ll_rate")] == [
        ["m", "measured_mean", "bound", "satisfied"]]
    assert [_keys(x) for x in _lines(text, "theory_thm41a")] == [
        ["tau", "epoch_iters", "nu_tau", "factor_bound", "measured",
         "satisfied"]]
    assert [_keys(x) for x in _lines(text, "theory_stepsize")] == (
        [["beta", "nu", "err_ratio"]] * 4 + [["beta_opt",
                                              "best_measured_beta"]])
    assert [_keys(x) for x in _lines(text, "theory_thm61")] == [
        ["tau", "beta", "omega", "err_ratio_8n", "converged"]]


# ---------------------------------------------------------------------------
# fig1_residual, n = 128, 4 RHS, 5 sweeps
# ---------------------------------------------------------------------------

F1_N, F1_RHS, F1_SWEEPS = 128, 4, 5


def test_fig1_matches_the_reference(capsys):
    r = ref_random_sparse_spd(F1_N, row_nnz=16, offdiag=0.97, n_rhs=F1_RHS,
                              seed=0)
    got_rgs, got_cg = fig1_residual.run(
        F1_N, F1_RHS, F1_SWEEPS, problem=_port(r),
        picks=_picks(1, F1_SWEEPS * F1_N, F1_N))
    text = capsys.readouterr().out
    x0 = jnp.zeros_like(r.x_star)
    b_norm = float(jnp.linalg.norm(r.b))
    res = ref_rgs_solve(r.A, r.b, x0, r.x_star, key=jax.random.key(1),
                        num_iters=F1_SWEEPS * F1_N, record_every=F1_N)
    cg = ref_cg_solve(r.A, r.b, x0, r.x_star, num_iters=F1_SWEEPS)
    rgs_r = np.linalg.norm(np.asarray(res.resid), axis=1) / b_norm
    cg_r = np.linalg.norm(np.asarray(cg.resid), axis=1) / b_norm
    _close(got_rgs, rgs_r, RTOL)
    _close(got_cg, cg_r, RTOL, atol=1e-6)
    sweeps = _lines(text, "fig1_residual")
    assert [_keys(x) for x in sweeps[:-1]] == [["sweep", "rgs", "cg"]] * 5
    summary = dict(sweeps[-1])
    assert list(summary) == [
        "summary", "kappa", "rgs_first_sweep", "cg_first_iter",
        "rgs_wins_early", "rgs_syncs_per_sweep", "cg_syncs_per_iter",
        "rgs_resid_monotone", "cg_resid_monotone"]
    want = dict(rgs_wins_early=int(rgs_r[0] < cg_r[0]),
                rgs_resid_monotone=int(bool(np.all(np.diff(rgs_r) < 0))),
                cg_resid_monotone=int(bool(np.all(np.diff(cg_r) < 0))),
                rgs_syncs_per_sweep=0, cg_syncs_per_iter=2)
    assert {k: int(summary[k]) for k in want} == want
    _close(float(summary["kappa"]), float(r.kappa), rtol=0.05)


# ---------------------------------------------------------------------------
# fig3_async_penalty, n = 64, tau (2, 4), two trials
# ---------------------------------------------------------------------------

F3_N, F3_TAUS, F3_TRIALS, F3_SWEEPS = 64, (2, 4), 2, 10


def test_fig3_matches_the_reference(capsys):
    r = ref_random_sparse_spd(F3_N, row_nnz=16, offdiag=0.95, n_rhs=4,
                              seed=0)
    iters = F3_SWEEPS * F3_N
    delays = {(tau, model): [(_uniform if model == "consistent"
                              else _misses)(100 + t, iters, tau)
                             for t in range(F3_TRIALS)]
              for tau in F3_TAUS for model in ("consistent", "inconsistent")}
    got = fig3_async_penalty.measure(F3_N, F3_SWEEPS, F3_TAUS, F3_TRIALS,
                                     problem=_port(r),
                                     picks=_picks(42, iters, F3_N),
                                     delays=delays)
    fig3_async_penalty.report(got)
    text = capsys.readouterr().out

    x0 = jnp.zeros_like(r.x_star)
    b_norm = float(jnp.linalg.norm(r.b))
    key = jax.random.key(42)
    sync = ref_rgs_solve(r.A, r.b, x0, r.x_star, key=key, num_iters=iters)
    sync_r = float(jnp.linalg.norm(sync.resid[-1]) / b_norm)
    _close(got["sync"], sync_r, RTOL)
    rho = float(ref_theory.rho(r.A))
    rho2 = float(ref_theory.rho2(r.A))
    rows = iter(got["rows"])
    for tau in F3_TAUS:
        for model in ("consistent", "inconsistent"):
            beta = 1.0
            if model == "inconsistent" or 2 * rho * tau >= 1:
                beta = (ref_theory.beta_opt_inconsistent(rho2, tau)
                        if model == "inconsistent"
                        else ref_theory.beta_opt(rho, tau))
            rs = [float(jnp.linalg.norm(ref_async_rgs_solve(
                r.A, r.b, x0, r.x_star, key=key,
                delay_key=jax.random.key(100 + t), num_iters=iters, tau=tau,
                beta=beta, read_model=model,
                delay_mode="uniform" if model == "consistent"
                else "fixed").resid[-1]) / b_norm)
                for t in range(F3_TRIALS)]
            row = next(rows)
            assert (row["tau"], row["model"]) == (tau, model)
            _close(row["beta"], beta)
            _close(row["resids"], rs, RTOL)
            _close(row["penalty"], np.mean(rs) / sync_r, RTOL)
    printed = _lines(text, "fig3_async_penalty")
    assert [_keys(x) for x in printed] == (
        [["variant", "tau", "resid"]]
        + [["variant", "tau", "beta", "resid_min", "resid_max",
            "penalty_vs_sync"]] * 4)


def test_fig3_streams_are_the_solvers_own_draws():
    """``fig3_async_penalty.streams`` draws what the solvers draw from the
    same generators (directions seeded 42, trial t's delays seeded 100 +
    t), so the default run, ``--draw-device`` and a replay on another
    device all run the documented streams: each solve equal on both."""
    from repro_torch.core import async_rgs_solve, rgs_solve
    prob = _port(ref_random_sparse_spd(F3_N, row_nnz=16, offdiag=0.95,
                                       n_rhs=4, seed=0))
    iters = F3_SWEEPS * F3_N
    picks, delays = fig3_async_penalty.streams(F3_N, iters, F3_TAUS,
                                               F3_TRIALS, torch.device("cpu"))
    assert picks.shape == (iters,)
    assert sorted(delays) == sorted(
        (tau, m) for tau in F3_TAUS for m in fig3_async_penalty.READ_MODELS)
    assert all(len(ds) == F3_TRIALS for ds in delays.values())
    x0 = torch.zeros_like(prob.x_star)
    A, b, xs = prob.A, prob.b, prob.x_star

    def gen(seed):
        return torch.Generator("cpu").manual_seed(seed)

    pairs = [(rgs_solve(A, b, x0, xs, num_iters=iters, generator=gen(42)),
              rgs_solve(A, b, x0, xs, num_iters=iters, picks=picks))]
    for (tau, model), ds in delays.items():
        kw = dict(num_iters=iters, tau=tau, beta=0.5, read_model=model,
                  delay_mode=fig3_async_penalty.DELAY_MODES[model])
        for t, d in enumerate(ds):
            pairs.append((
                async_rgs_solve(A, b, x0, xs, generator=gen(42),
                                delay_generator=gen(100 + t), **kw),
                async_rgs_solve(A, b, x0, xs, picks=picks, delays=d, **kw)))
    for drawn, given in pairs:
        np.testing.assert_array_equal(given.x.numpy(), drawn.x.numpy())
        np.testing.assert_array_equal(given.resid.numpy(),
                                      drawn.resid.numpy())


# ---------------------------------------------------------------------------
# run.py
# ---------------------------------------------------------------------------

def test_runner_runs_the_filtered_jobs_and_reports_a_failure(capsys,
                                                             monkeypatch):
    calls = []

    def fake_jobs(fast, device):
        def boom():
            raise RuntimeError("no card")
        return [("fig1_residual", lambda: calls.append(("fig1", fast,
                                                        device.type))),
                ("fig2_scaling", boom),
                ("theory_validation", lambda: calls.append("theory"))]

    monkeypatch.setattr(paper_run, "jobs", fake_jobs)
    paper_run.main(["--only", "fig", "--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert calls == [("fig1", True, "cpu")]
    assert "fig2_scaling,error=RuntimeError:no card" in out
    assert "# === fig1_residual ===" in out and "theory" not in out


def test_runner_jobs_keep_the_reference_sizes():
    names = [name for name, _ in paper_run.jobs(False, torch.device("cpu"))]
    assert names == ["fig1_residual", "fig2_scaling", "fig3_async_penalty",
                     "theory_validation"]


def test_runner_runs_theory_validation_fast_on_the_cpu(capsys):
    paper_run.main(["--only", "theory", "--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "theory_validation,error" not in out
    for name in ("theory_ll_rate", "theory_thm41a", "theory_thm61"):
        assert len(_lines(out, name)) == 1
