"""repro_torch's CG baselines (``core/cg.py``) against the reference's, and
the reference's own three CG claims (tests/test_cg.py) on the port.

Both packages get the same matrix, b and x_star (the reference problem's,
as numpy).  Flexible CG's preconditioner takes the reference's block
streams (``jax.random.randint(jax.random.key(seed + i), ...)`` for the
i-th application) through ``block_streams``.  Tolerances: x within rtol
1e-5 (relative norm) and each record (err_sq, resid) within 1e-5 of the
column's first record (f32 products and sums in other orders; CG's
residuals fall by orders of magnitude, so a relative bound per record
would read rounding noise).  Within the port a solo column is bitwise the
same column of a batched solve (fixed 64-column product groups and
``ops.colsum``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cg as ref_cg  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (cg_solve, fcg_solve,  # noqa: E402
                              make_rgs_preconditioner)
from repro_torch.kernels import ops  # noqa: E402

RTOL = 1e-5


def _pair(r):
    return r, convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                             r.lam_max, "cpu")


@pytest.fixture(scope="module")
def prob():
    return _pair(ref_spd.random_sparse_spd(256, row_nnz=8, n_rhs=3, seed=2))


@pytest.fixture(scope="module")
def lap():
    return _pair(ref_spd.laplacian_spd(16, shift=1e-2, n_rhs=2, seed=0))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same_records(got, want):
    assert _rel(got.x.numpy(), want.x) <= RTOL
    for g, w in ((got.err_sq, want.err_sq), (got.resid, want.resid)):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert np.all(np.abs(g.numpy() - w) <= RTOL * w[0])
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


@pytest.mark.parametrize("iters", [1, 10, 40])
def test_cg_matches_reference(prob, iters):
    r, p = prob
    want = ref_cg.cg_solve(r.A, r.b, jnp.zeros_like(r.x_star), r.x_star,
                           num_iters=iters)
    got = cg_solve(p.A, p.b, torch.zeros_like(p.x_star), p.x_star,
                   num_iters=iters)
    _same_records(got, want)


def test_cg_frozen_columns_stay_finite(prob):
    """A column that starts solved (b = 0) is frozen by the rs > 1e-30
    guard: x stays 0 and nothing turns NaN, as in the reference."""
    r, p = prob
    b = np.array(r.b)
    b[:, 1] = 0.0
    xs = np.array(r.x_star)
    xs[:, 1] = 0.0
    want = ref_cg.cg_solve(r.A, jnp.asarray(b), jnp.zeros_like(r.x_star),
                           jnp.asarray(xs), num_iters=12)
    got = cg_solve(p.A, torch.from_numpy(b), torch.zeros_like(p.x_star),
                   torch.from_numpy(xs), num_iters=12)
    assert torch.isfinite(got.x).all() and not got.x[:, 1].any()
    np.testing.assert_array_equal(np.asarray(want.x)[:, 1], 0.0)
    assert torch.isfinite(got.resid).all() and torch.isfinite(got.err_sq).all()


def _ref_streams(n, block, sweeps, seed, count):
    nb = n // block
    return [np.array(jax.random.randint(jax.random.key(seed + i),
                                        (sweeps * nb,), 0, nb))
            for i in range(count)]


@pytest.mark.parametrize("block,sweeps,beta", [(16, 2, 1.0), (32, 1, 0.8)])
def test_fcg_on_the_reference_block_streams(lap, block, sweeps, beta):
    r, p = lap
    iters = 12
    ref_pre = ref_cg.make_rgs_preconditioner(r.A, sweeps=sweeps, block=block,
                                             beta=beta)
    want = ref_cg.fcg_solve(r.A, r.b, jnp.zeros_like(r.x_star), r.x_star,
                            precond=ref_pre, num_iters=iters)
    pre = make_rgs_preconditioner(
        p.A, sweeps=sweeps, block=block, beta=beta,
        block_streams=_ref_streams(p.n, block, sweeps, 7, iters + 1))
    got = fcg_solve(p.A, p.b, torch.zeros_like(p.x_star), p.x_star,
                    precond=pre, num_iters=iters)
    _same_records(got, want)


def test_preconditioner_is_one_block_gs_sweep_per_application(lap,
                                                              monkeypatch):
    """Each application is one ``ops.block_gs_sweep`` call from z = 0 over
    ``sweeps * n // block`` blocks drawn from a generator seeded seed + i."""
    _, p = lap
    calls = []
    real = ops.block_gs_sweep

    def spy(A, b, x, blocks, **kw):
        calls.append((blocks.clone(), bool(x.any()), kw))
        return real(A, b, x, blocks, **kw)
    monkeypatch.setattr(ops, "block_gs_sweep", spy)
    pre = make_rgs_preconditioner(p.A, sweeps=2, block=16, beta=0.9, seed=5)
    r = p.b.clone()
    z0, z1 = pre(r), pre(r)
    assert len(calls) == 2
    for i, (blocks, x_nonzero, kw) in enumerate(calls):
        want = torch.randint(0, 16, (32,),
                             generator=torch.Generator().manual_seed(5 + i))
        assert torch.equal(blocks, want) and not x_nonzero
        assert kw == {"block": 16, "beta": 0.9}
    assert not torch.equal(z0, z1)


def test_solo_column_is_bitwise_the_batched_column(prob, lap):
    _, p = prob
    full = cg_solve(p.A, p.b, torch.zeros_like(p.b), p.x_star, num_iters=20)
    one = cg_solve(p.A, p.b[:, 1:2].contiguous(),
                   torch.zeros_like(p.b[:, 1:2]),
                   p.x_star[:, 1:2].contiguous(), num_iters=20)
    for a, b in ((one.x, full.x), (one.resid, full.resid),
                 (one.err_sq, full.err_sq)):
        np.testing.assert_array_equal(a[:, 0].numpy(), b[:, 1].numpy())
    _, q = lap
    streams = _ref_streams(q.n, 16, 2, 7, 9)
    kw = dict(sweeps=2, block=16, beta=1.0)
    fa = fcg_solve(q.A, q.b, torch.zeros_like(q.b), q.x_star, num_iters=8,
                   precond=make_rgs_preconditioner(q.A, block_streams=streams,
                                                   **kw))
    fo = fcg_solve(q.A, q.b[:, :1].contiguous(), torch.zeros_like(q.b[:, :1]),
                   q.x_star[:, :1].contiguous(), num_iters=8,
                   precond=make_rgs_preconditioner(q.A, block_streams=streams,
                                                   **kw))
    np.testing.assert_array_equal(fo.x[:, 0].numpy(), fa.x[:, 0].numpy())
    np.testing.assert_array_equal(fo.resid[:, 0].numpy(),
                                  fa.resid[:, 0].numpy())


# The reference's own claims (tests/test_cg.py), on the port.

def test_cg_converges_fast(prob):
    _, p = prob
    res = cg_solve(p.A, p.b, torch.zeros_like(p.x_star), p.x_star,
                   num_iters=40)
    assert float(res.resid[-1].max()) < 1e-5
    e = res.err_sq[:, 0].numpy()
    assert e[-1] < e[0] * 1e-6


def test_cg_multi_rhs_independent(prob):
    _, p = prob
    res = cg_solve(p.A, p.b, torch.zeros_like(p.x_star), p.x_star,
                   num_iters=30)
    one = cg_solve(p.A, p.b[:, 1:2], torch.zeros_like(p.x_star[:, 1:2]),
                   p.x_star[:, 1:2], num_iters=30)
    np.testing.assert_allclose(res.x[:, 1].numpy(), one.x[:, 0].numpy(),
                               atol=1e-4)


def test_fcg_with_rgs_preconditioner_beats_plain_cg_periteration(lap):
    _, p = lap
    x0 = torch.zeros_like(p.x_star)
    iters = 12
    plain = cg_solve(p.A, p.b, x0, p.x_star, num_iters=iters)
    pre = make_rgs_preconditioner(p.A, sweeps=2, block=16, beta=1.0)
    flex = fcg_solve(p.A, p.b, x0, p.x_star, precond=pre, num_iters=iters)
    assert float(flex.resid[-1].max()) < float(plain.resid[-1].max())
    assert float(flex.resid[-1].max()) < 1e-2 * float(flex.resid[0].max())
