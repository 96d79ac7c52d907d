"""repro_torch's dense least-squares problem (``random_lsq``), its Kaczmarz
wrappers (``rk_solve``, ``async_rk_solve``) and the general-diagonal GS
iteration (``rgs_general``) against the reference's.

``random_lsq`` runs the reference's numpy construction, so A, b and
x_true must be bitwise the reference's; x_star (``lstsq``, when there is
noise) within rtol 1e-4 (relative norm; different LAPACK drivers) and the
singular values within rtol 1e-5.  The solvers get the reference's row
and delay streams as ``picks=``/``delays=``: x within rtol 1e-5 (relative
norm) and each record within rtol 1e-4.  ``rgs_general`` gets the
reference's coordinates: y within rtol 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kaczmarz as ref_kaczmarz  # noqa: E402
from repro.core import rgs as ref_rgs  # noqa: E402
from repro.core.engine import sample_rows as ref_sample_rows  # noqa: E402
from repro.core.operators import DenseOp as RefDenseOp  # noqa: E402
from repro_torch.core import (async_rk_solve, kaczmarz,  # noqa: E402
                              random_lsq, rgs_general, rk_solve,
                              to_unit_diagonal)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("noise,col_scale", [(0.0, 1.0), (0.01, 0.5),
                                             (0.05, 0.0), (0.0, 0.0)])
def test_random_lsq_matches_reference(noise, col_scale):
    want = ref_kaczmarz.random_lsq(96, 24, n_rhs=3, noise=noise,
                                   col_scale=col_scale, seed=4)
    got = random_lsq(96, 24, n_rhs=3, noise=noise, col_scale=col_scale,
                     seed=4, device="cpu")
    for f in ("A", "b", "x_true"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    if noise:
        assert _rel(got.x_star.numpy(), want.x_star) <= 1e-4
        assert not torch.equal(got.x_star, got.x_true)
    else:
        assert torch.equal(got.x_star, got.x_true)
    np.testing.assert_allclose(
        [float(got.sigma_min), float(got.sigma_max)],
        [float(want.sigma_min), float(want.sigma_max)], rtol=1e-5)
    assert got.shape == (96, 24)
    np.testing.assert_allclose(float(got.kappa), float(want.kappa), rtol=1e-5)


def test_random_lsq_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_lsq(16, 4)
    with pytest.raises(ValueError, match="m >= n"):
        random_lsq(4, 16, device="cpu")


@pytest.fixture(scope="module")
def lsq():
    r = ref_kaczmarz.random_lsq(128, 16, n_rhs=2, noise=0.01, col_scale=0.5,
                                seed=2)
    return r, random_lsq(128, 16, n_rhs=2, noise=0.01, col_scale=0.5, seed=2,
                         device="cpu")


def _same(got, want):
    assert _rel(got.x.numpy(), want.x) <= 1e-5
    np.testing.assert_allclose(got.err_sq.numpy(), np.asarray(want.err_sq),
                               rtol=1e-4)
    np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid),
                               rtol=1e-4)


@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_rk_solve_matches_reference(lsq, beta):
    r, p = lsq
    key = jax.random.key(8)
    iters = 3 * 128
    want = ref_kaczmarz.rk_solve(r.A, r.b, jnp.zeros_like(r.x_star),
                                 r.x_star, key=key, num_iters=iters,
                                 beta=beta, record_every=128)
    picks = np.array(ref_sample_rows(key, RefDenseOp(r.A).row_norms_sq(),
                                     iters))
    got = rk_solve(p.A, p.b, torch.zeros_like(p.x_star), p.x_star,
                   num_iters=iters, picks=torch.from_numpy(picks), beta=beta,
                   record_every=128)
    _same(got, want)


@pytest.mark.parametrize("mode", ["fixed", "uniform", "inconsistent"])
def test_async_rk_solve_matches_reference(lsq, mode):
    r, p = lsq
    key, dkey = jax.random.key(9), jax.random.key(10)
    iters, tau = 3 * 128, 8
    kw = (dict(read_model="inconsistent", miss_prob=0.3)
          if mode == "inconsistent" else dict(delay_mode=mode))
    want = ref_kaczmarz.async_rk_solve(
        r.A, r.b, jnp.zeros_like(r.x_star), r.x_star, key=key,
        delay_key=dkey, num_iters=iters, tau=tau, beta=0.5, record_every=128,
        **kw)
    picks = np.array(ref_sample_rows(key, RefDenseOp(r.A).row_norms_sq(),
                                     iters))
    delays = {"fixed": None,
              "uniform": jax.random.randint(dkey, (iters,), 0, tau + 1),
              "inconsistent": jax.random.bernoulli(dkey, 0.3, (iters, tau))
              }[mode]
    got = async_rk_solve(
        p.A, p.b, torch.zeros_like(p.x_star), p.x_star, num_iters=iters,
        tau=tau, picks=torch.from_numpy(picks),
        delays=None if delays is None else torch.from_numpy(np.array(delays)),
        beta=0.5, record_every=128, **kw)
    _same(got, want)


def test_rk_solve_from_a_generator_converges(lsq):
    """The port's own stream: the error and the residual fall (the design
    has kappa 40, so 20 sweeps are far from the optimum)."""
    _, p = lsq
    res = rk_solve(p.A, p.b, torch.zeros_like(p.x_star), p.x_star,
                   num_iters=20 * 128, generator=torch.Generator()
                   .manual_seed(0), record_every=128)
    b_norm = torch.linalg.vector_norm(p.b, dim=0)
    assert bool((res.resid[-1] < 0.5 * b_norm).all())
    assert bool((res.err_sq[-1] < 0.5 * res.err_sq[0]).all())


@pytest.mark.parametrize("P,L", [(1, 64), (4, 64), (8, 16)])
def test_rk_effective_tau_matches_reference(P, L):
    assert kaczmarz.rk_effective_tau(P, L) == \
        ref_kaczmarz.rk_effective_tau(P, L)


@pytest.mark.parametrize("beta", [1.0, 0.6])
def test_rgs_general_matches_reference(beta):
    rng = np.random.default_rng(0)
    G = rng.standard_normal((48, 48))
    B = (G @ G.T + 8 * np.eye(48)).astype(np.float32)
    z = rng.standard_normal((48, 2)).astype(np.float32)
    coords = jax.random.randint(jax.random.key(5), (400,), 0, 48)
    want = ref_rgs.rgs_general(jnp.asarray(B), jnp.asarray(z),
                               jnp.zeros((48, 2), jnp.float32), coords=coords,
                               beta=beta, num_iters=400)
    got = rgs_general(torch.from_numpy(B), torch.from_numpy(z),
                      torch.zeros((48, 2)),
                      coords=torch.from_numpy(np.array(coords)), beta=beta,
                      num_iters=400)
    assert _rel(got.numpy(), want) <= 1e-5


def test_unit_diagonal_reduction():
    """Sec 2.3 (the reference's tests/test_rgs.py claim, on the port): the
    general iteration on B is the unit-diagonal iteration on D B D with
    y = D x, on the same directions."""
    rng = np.random.default_rng(0)
    G = rng.standard_normal((48, 48))
    B = torch.from_numpy((G @ G.T + 8 * np.eye(48)).astype(np.float32))
    A, d = to_unit_diagonal(B)
    z = torch.from_numpy(rng.standard_normal((48, 1)).astype(np.float32))
    coords = torch.randint(0, 48, (400,),
                           generator=torch.Generator().manual_seed(5))
    y = rgs_general(B, z, torch.zeros((48, 1)), coords=coords)
    bz = d[:, None] * z
    x = torch.zeros((48, 1))
    for r in coords.tolist():
        x[r] += bz[r] - A[r] @ x
    np.testing.assert_allclose(y[:, 0].numpy(), (d[:, None] * x)[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)
