"""repro_torch's rate formulas (``core/theory.py``) against the reference's
on the same arrays.

The matrices come from the reference's numpy constructions (a
reference-scenario SPD matrix, a Gaussian LSQ design), handed to both
packages.  Tolerances: matrix functions within rtol 1e-5 (f32 sums in
different orders; the SVD- and eigensolver-based ones from different
LAPACK drivers, 1e-4); Lanczos, fed the reference's start vector, within
rtol 1e-4 of the reference's Ritz extremes; the scalar formulas, plain
Python arithmetic in both, exactly equal, errors included.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import random_lsq as ref_random_lsq  # noqa: E402
from repro.core import random_sparse_spd as ref_spd  # noqa: E402
from repro.core import theory as ref_theory  # noqa: E402
from repro_torch.core import theory  # noqa: E402


@pytest.fixture(scope="module")
def spd():
    A = np.asarray(ref_spd(64, row_nnz=6, n_rhs=1, seed=3).A)
    return A, torch.from_numpy(A.copy())


@pytest.fixture(scope="module")
def design():
    A = np.asarray(ref_random_lsq(96, 24, col_scale=0.5, seed=1).A)
    return A, torch.from_numpy(A.copy())


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("name,args", [("rho", ()), ("rho2", ()),
                                       ("block_rho", (8,)),
                                       ("block_rho", (1,))])
def test_matrix_constants_match_reference(spd, name, args):
    A, At = spd
    _close(float(getattr(theory, name)(At, *args)),
           float(getattr(ref_theory, name)(jnp.asarray(A), *args)))


def test_block_rho_at_block_one_is_rho(spd):
    _, At = spd
    _close(float(theory.block_rho(At, 1)), float(theory.rho(At)))


def test_extreme_eigs_dense_matches_reference(spd):
    A, At = spd
    got = theory.extreme_eigs_dense(At)
    want = ref_theory.extreme_eigs_dense(jnp.asarray(A))
    _close([float(v) for v in got], [float(v) for v in want], rtol=1e-4)


@pytest.mark.parametrize("iters", [8, 32, 64])
def test_lanczos_on_the_reference_start_vector(spd, iters):
    A, At = spd
    key = jax.random.key(11)
    v0 = np.array(jax.random.normal(key, (A.shape[0],), jnp.float32))
    got = theory.lanczos_extreme_eigs(At, v0=torch.from_numpy(v0),
                                      iters=iters)
    want = ref_theory.lanczos_extreme_eigs(jnp.asarray(A), key, iters=iters)
    _close([float(v) for v in got], [float(v) for v in want], rtol=1e-4)


def test_lanczos_from_a_generator_brackets_the_spectrum(spd):
    """At iters >= n the Krylov space is whole: the Ritz extremes are the
    spectrum's (the beta > 1e-12 guard keeps the exhausted steps
    finite)."""
    _, At = spd
    lo, hi = theory.lanczos_extreme_eigs(
        At, generator=torch.Generator().manual_seed(0), iters=64)
    dlo, dhi = theory.extreme_eigs_dense(At)
    assert math.isfinite(float(lo)) and math.isfinite(float(hi))
    _close([float(lo), float(hi)], [float(dlo), float(dhi)], rtol=1e-4)
    with pytest.raises(ValueError, match="generator or v0"):
        theory.lanczos_extreme_eigs(At)


SCALARS = [
    ("nu_tau", (0.01, 8, 0.7)), ("nu_tau", (0.02, 3)),
    ("beta_opt", (0.01, 8)), ("omega_tau", (0.003, 6, 0.4)),
    ("beta_opt_inconsistent", (0.003, 6)),
    ("chi_consistent", (0.01, 4, 1.3, 64, 0.8)),
    ("epoch_len", (1.3, 64)), ("ll_bound", (2.0, 100, 0.2, 64)),
    ("thm41a_factor", (0.01, 8, 7.0, 0.6)),
    ("thm61a_factor", (0.003, 6, 7.0, 0.4)),
    ("iters_to_eps", (64, 0.2, 1e-3, 0.1)), ("rk_bound", (3.0, 50, 0.99)),
    ("beta_opt_rk", (0.05, 32)), ("perturbed_factor", (0.81, 0.05)),
    ("perturbed_factor", (-0.1, 0.0)), ("perturbed_factor", (0.9, 0.5)),
    ("iteration_inflation", (0.81, 0.05)),
    ("iteration_inflation", (0.81, 0.2)),
]


@pytest.mark.parametrize("name,args", SCALARS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCALARS)])
def test_scalar_formulas_equal_reference(name, args):
    got = getattr(theory, name)(*args)
    want = getattr(ref_theory, name)(*args)
    assert got == want and type(got) is type(want)


ERRORS = [
    ("chi_consistent", (0.01, 4, 64.0, 64)), ("chi_consistent", (0.01, 4,
                                                                 0.0, 64)),
    ("epoch_len", (64.0, 64)), ("epoch_len", (70.0, 64)),
    ("epoch_len", (-1.0, 64)), ("perturbed_factor", (0.5, -0.1)),
    ("iteration_inflation", (1.0, 0.1)), ("iteration_inflation", (0.0, 0.1)),
]


@pytest.mark.parametrize("name,args", ERRORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ERRORS)])
def test_scalar_errors_equal_reference(name, args):
    with pytest.raises(ValueError) as want:
        getattr(ref_theory, name)(*args)
    with pytest.raises(ValueError) as got:
        getattr(theory, name)(*args)
    assert str(got.value) == str(want.value)


def test_iteration_inflation_degenerate_is_inf():
    assert theory.iteration_inflation(0.81, 0.2) == math.inf


@pytest.mark.parametrize("name,args", [
    ("rk_row_probs", ()), ("rk_rho", ()), ("rk_rho2", ()),
    ("rk_factor", ()), ("rk_factor", (0.7,)),
    ("async_rk_factor", (8, 0.6)), ("async_rk_factor", (8, 0.6, 0.05))])
def test_rk_functions_match_reference(design, name, args):
    A, At = design
    got = np.asarray(getattr(theory, name)(At, *args))
    want = np.asarray(getattr(ref_theory, name)(jnp.asarray(A), *args))
    _close(got, want, rtol=1e-4 if "factor" in name else 1e-5)


def test_rk_rho_reduces_to_rho_on_uniform_unit_diagonal():
    """On a square matrix with unit rows, uniform sampling and orthogonal
    rows (the identity) every coherence is 0 or 1: rk_rho = rho = 1/n."""
    eye = torch.eye(16)
    _close(float(theory.rk_rho(eye)), float(theory.rho(eye)))
