"""The port's examples (``repro_torch.examples``) against the reference's
examples' calls into ``repro.core``, at small sizes on the CPU: the
quickstart at n = 128, the regression at 512 x 64 with 51 targets.

The quickstart gets the reference's problem and its streams (directions
``randint(key(1), ...)``, delays ``randint(key(2), ..., 0, 33)``); the
regression builds its problem itself from the reference's numpy code
(bitwise equal, checked here) and gets the reference's rows
(``sample_rows(key(0), ...)``; its fixed delays draw nothing).
Tolerances: residual records within rtol 1e-4 (CG's also within
1e-6·||b|| absolute, for its f32 floor), beta within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import (LSQProblem, Schedule, cg_solve,  # noqa: E402
                        random_sparse_spd, solve, theory, to_unit_diagonal)
from repro.core.engine import sample_rows  # noqa: E402
from repro.core.operators import DenseOp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import quickstart, solve_regression  # noqa: E402

RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _norms(resid):
    return np.linalg.norm(np.asarray(resid, np.float64), axis=1)


def test_quickstart_matches_the_reference(capsys):
    n, sweeps, tau = 128, quickstart.SWEEPS, quickstart.TAU
    r = random_sparse_spd(n, row_nnz=16, offdiag=0.95, n_rhs=4, seed=0)
    iters = sweeps * n
    got = quickstart.run(
        n, problem=convert.spd_problem_from_numpy(r.A, r.b, r.x_star,
                                                  r.lam_min, r.lam_max,
                                                  "cpu"),
        picks=_t(jax.random.randint(jax.random.key(1), (iters,), 0, n)),
        delays=_t(jax.random.randint(jax.random.key(2), (iters,), 0,
                                     tau + 1)))
    out = capsys.readouterr().out
    res = solve(r, key=jax.random.key(1),
                schedule=Schedule(num_iters=iters, record_every=n))
    beta = theory.beta_opt(float(theory.rho(r.A)), tau)
    ares = solve(r, key=jax.random.key(1), delay_key=jax.random.key(2),
                 beta=beta, delay_mode="uniform",
                 schedule=Schedule(num_iters=iters, tau=tau, record_every=n))
    cg = cg_solve(r.A, r.b, jnp.zeros_like(r.x_star), r.x_star,
                  num_iters=sweeps)
    bn = float(jnp.linalg.norm(r.b))
    _close(got["beta"], beta, rtol=1e-5)
    _close(_norms(got["sync"].resid), _norms(res.resid))
    _close(_norms(got["async"].resid), _norms(ares.resid))
    _close(_norms(got["cg"].resid), _norms(cg.resid), atol=1e-6 * bn)
    assert out.count("sync RGS  sweep") == 3
    assert "async RGS (tau=32" in out and "CG        iter  10" in out


def _reference_build(n_samples, n_features, n_targets, seed=0):
    """The reference example's construction, line for line."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_samples, n_features)).astype(np.float32)
    X *= rng.exponential(1.0, n_features).astype(np.float32)
    W_true = rng.standard_normal((n_features, n_targets)).astype(np.float32)
    Y = X @ W_true + 0.1 * rng.standard_normal(
        (n_samples, n_targets)).astype(np.float32)
    return X, Y, W_true


M, NF, NT = 512, 64, 51


def test_regression_problem_is_bitwise_the_reference():
    for got, want in zip(solve_regression.build_problem(M, NF, NT),
                         _reference_build(M, NF, NT)):
        np.testing.assert_array_equal(got, want)


def test_regression_lstsq_is_the_reference_at_the_default_size():
    """At 4096 x 1024 (kappa(X) about 4048) the reference's lstsq drops
    singular values below eps * 4096 of the largest; the port's does the
    same (torch's default CPU driver would give another, far worse x)."""
    Xn, Yn, _ = solve_regression.build_problem()
    got = solve_regression.lstsq(torch.from_numpy(Xn), torch.from_numpy(Yn))
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(Xn), jnp.asarray(Yn))[0])
    assert (np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
            <= 1e-3)
    floor = np.linalg.norm(Yn - Xn @ got.numpy()) / np.linalg.norm(Yn)
    _close(floor, np.linalg.norm(Yn - Xn @ want) / np.linalg.norm(Yn))


def test_regression_matches_the_reference(capsys):
    sweeps, tau = solve_regression.SWEEPS, solve_regression.TAU
    Xn, Yn, Wn = _reference_build(M, NF, NT)
    X, Y, W_true = jnp.asarray(Xn), jnp.asarray(Yn), jnp.asarray(Wn)
    W_star = jnp.linalg.lstsq(X, Y)[0]
    s = jnp.linalg.svd(X, compute_uv=False)
    prob = LSQProblem(A=X, b=Y, x_star=W_star, x_true=W_true,
                      sigma_min=s[-1], sigma_max=s[0])
    rows = sample_rows(jax.random.key(0), DenseOp(X).row_norms_sq(),
                       sweeps * M)
    got = solve_regression.run(M, NF, NT, device="cpu", picks=_t(rows))
    out = capsys.readouterr().out
    res = solve(prob, key=jax.random.key(0),
                schedule=Schedule(num_iters=sweeps * M, record_every=M))
    beta = theory.beta_opt_rk(float(theory.rk_rho(X)), tau)
    ares = solve(prob, key=jax.random.key(0), delay_key=jax.random.key(1),
                 beta=beta, schedule=Schedule(num_iters=sweeps * M, tau=tau,
                                              record_every=M))
    B, d = to_unit_diagonal(X.T @ X)
    cg = cg_solve(B, d[:, None] * (X.T @ Y), jnp.zeros_like(W_star),
                  W_star / d[:, None], num_iters=sweeps)
    W_cg = d[:, None] * cg.x
    yn = float(jnp.linalg.norm(Y))
    _close(got["beta"], beta, rtol=1e-5)
    _close(_norms(got["sync"].resid), _norms(res.resid))
    _close(_norms(got["async"].resid), _norms(ares.resid))
    _close(float(torch.linalg.norm(torch.from_numpy(Yn)
                                   - torch.from_numpy(Xn) @ got["W_cg"])),
           float(jnp.linalg.norm(Y - X @ W_cg)), atol=1e-6 * yn)
    _close(got["rel_w"], float(jnp.linalg.norm(ares.x - W_true)
                               / jnp.linalg.norm(W_true)))
    _close(got["floor"], float(jnp.linalg.norm(Y - X @ W_star)) / yn)
    for head in ("least squares: m=512, n=64, targets=51", "sync RK",
                 "async RK", "CG (X^T X)", "downstream"):
        assert head in out


def test_examples_take_their_sizes_and_device(capsys):
    got = quickstart.main(["--n", "64", "--device", "cpu"])
    assert got["sync"].x.shape == (64, 4)
    got = solve_regression.main(["--samples", "256", "--features", "32",
                                 "--targets", "3", "--device", "cpu"])
    assert got["async"].x.shape == (32, 3)
    assert "m=256, n=32, targets=3" in capsys.readouterr().out
