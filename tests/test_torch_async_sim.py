"""repro_torch's bounded-delay simulator (``engine.solve_async_sim``,
``async_rgs_solve``) against the reference's, and its contracts within the
port.

Both packages get the same matrix, b and x_star (the reference problem's),
the same direction stream (the reference's ``randint`` / ``sample_rows``
for its key) and the same delays (the reference's
``jax.random.randint(delay_key, (num_iters,), 0, tau + 1)`` or
``jax.random.bernoulli(delay_key, miss_prob, (num_iters, tau))``), handed
to the port as ``picks=`` and ``delays=``.  Tolerances: x within rtol 1e-5
(relative norm) and each record within rtol 1e-4 of the reference's
(the stale-read correction sums its terms in another order than the
reference's masked product).  Within the port, tau = 0 is bitwise the
sequential GS engine on the same picks, and a densified CSR operator is
bitwise the dense one.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import async_rgs as ref_async_rgs  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro.core.operators import DenseOp as RefDenseOp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (async_rgs_solve,  # noqa: E402
                              iteration_identity_gap, rgs_solve)
from repro_torch.core.engine import (Schedule, draw_delays,  # noqa: E402
                                     solve, solve_async_sim,
                                     solve_sequential)
from repro_torch.core.operators import CsrOp, DenseOp  # noqa: E402

N, TAU, MISS = 64, 6, 0.5
ITERS, REC = 4 * N, N


@pytest.fixture(scope="module")
def prob():
    r = ref_spd.random_sparse_spd(N, row_nnz=6, n_rhs=2, seed=1)
    return r, convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                             r.lam_max, "cpu")


def _ref_streams(r, action, mode, key, dkey):
    op = RefDenseOp(r.A)
    if action == "gs":
        picks = jax.random.randint(key, (ITERS,), 0, N)
    else:
        picks = ref_engine.sample_rows(key, op.row_norms_sq(), ITERS)
    if mode == "inconsistent":
        delays = jax.random.bernoulli(dkey, MISS, (ITERS, TAU))
    elif mode == "uniform":
        delays = jax.random.randint(dkey, (ITERS,), 0, TAU + 1)
    else:
        delays = None       # fixed and cyclic draw nothing
    return (torch.from_numpy(np.array(picks)),
            None if delays is None else torch.from_numpy(np.array(delays)))


def _kw(mode):
    if mode == "inconsistent":
        return dict(read_model="inconsistent", miss_prob=MISS)
    return dict(delay_mode=mode)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", ["fixed", "uniform", "cyclic",
                                  "inconsistent"])
@pytest.mark.parametrize("action", ["gs", "rk"])
def test_simulator_matches_reference(prob, action, mode):
    r, p = prob
    key, dkey = jax.random.key(3), jax.random.key(4)
    beta = 0.8 if action == "gs" else 0.5
    want = ref_engine.solve_async_sim(
        RefDenseOp(r.A), r.b, jnp.zeros_like(r.b), r.x_star, action=action,
        key=key, delay_key=dkey, num_iters=ITERS, tau=TAU, beta=beta,
        record_every=REC, **_kw(mode))
    picks, delays = _ref_streams(r, action, mode, key, dkey)
    got = solve_async_sim(
        DenseOp(p.A), p.b, torch.zeros_like(p.b), p.x_star, action=action,
        num_iters=ITERS, tau=TAU, picks=picks, delays=delays, beta=beta,
        record_every=REC, **_kw(mode))
    assert _rel(got.x.numpy(), want.x) <= 1e-5
    np.testing.assert_allclose(got.err_sq.numpy(), np.asarray(want.err_sq),
                               rtol=1e-4)
    np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


@pytest.mark.parametrize("mode", ["fixed", "uniform", "cyclic",
                                  "inconsistent"])
def test_tau0_is_bitwise_sequential_gs(prob, mode):
    _, p = prob
    picks = torch.randint(0, N, (ITERS,),
                          generator=torch.Generator().manual_seed(0))
    seq = rgs_solve(p.A, p.b, torch.zeros_like(p.b), p.x_star,
                    num_iters=ITERS, picks=picks, record_every=REC)
    asy = async_rgs_solve(p.A, p.b, torch.zeros_like(p.b), p.x_star,
                          num_iters=ITERS, tau=0, picks=picks,
                          delay_generator=torch.Generator().manual_seed(1),
                          record_every=REC, **_kw(mode))
    for a, b in ((asy.x, seq.x), (asy.err_sq, seq.err_sq),
                 (asy.resid, seq.resid)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_reference_tau0_claim_on_the_port(prob):
    """The reference pins tau = 0 async == sync RGS bit for bit within
    itself (tests/test_async_rgs.py); the port's own generator stream."""
    _, p = prob
    gen = dict(generator=torch.Generator().manual_seed(3))
    a = rgs_solve(p.A, p.b, torch.zeros_like(p.b), p.x_star, num_iters=300,
                  **gen)
    b = async_rgs_solve(p.A, p.b, torch.zeros_like(p.b), p.x_star,
                        num_iters=300, tau=0,
                        generator=torch.Generator().manual_seed(3),
                        delay_generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.x, b.x)


def test_csr_is_densified_exactly_with_a_warning(prob):
    _, p = prob
    picks = torch.randint(0, N, (ITERS,),
                          generator=torch.Generator().manual_seed(5))
    kw = dict(action="gs", num_iters=ITERS, tau=TAU, picks=picks,
              record_every=REC)
    with pytest.warns(UserWarning, match="densifies CsrOp exactly"):
        got = solve_async_sim(CsrOp.from_dense(p.A), p.b,
                              torch.zeros_like(p.b), p.x_star, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = solve_async_sim(DenseOp(p.A), p.b, torch.zeros_like(p.b),
                               p.x_star, **kw)
    assert torch.equal(got.x, want.x) and torch.equal(got.resid, want.resid)


def test_iteration_identity_matches_reference(prob):
    r, p = prob
    rng = np.random.default_rng(7)
    x, x_stale = (rng.standard_normal(N).astype(np.float32)
                  for _ in range(2))
    for row, beta in ((3, 1.0), (40, 0.4)):
        want = ref_async_rgs.iteration_identity_gap(
            r.A, r.b[:, 0], jnp.asarray(x), r.x_star[:, 0],
            jnp.asarray(x_stale), row, beta)
        lhs, rhs = iteration_identity_gap(
            p.A, p.b[:, 0], torch.from_numpy(x), p.x_star[:, 0],
            torch.from_numpy(x_stale), row, beta)
        np.testing.assert_allclose([float(lhs), float(rhs)],
                                   [float(v) for v in want], rtol=1e-5)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("kw,match", [
    (dict(rounds=2, local_steps=4, tau=3), "ambiguous"),
    (dict(tau=3), "num_iters > 0"),
    (dict(num_iters=8, tau=-1), "tau must be >= 0"),
    (dict(tau=2, local_steps=4, num_iters=8), "local_steps without rounds"),
])
def test_schedule_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        Schedule(**kw).validate()


def test_front_door_routes_tau_to_the_simulator(prob):
    _, p = prob
    picks = torch.randint(0, N, (ITERS,),
                          generator=torch.Generator().manual_seed(6))
    delays = torch.randint(0, TAU + 1, (ITERS,),
                           generator=torch.Generator().manual_seed(7))
    sched = Schedule(num_iters=ITERS, tau=TAU, record_every=REC)
    got = solve(p, schedule=sched, picks=picks, delays=delays,
                delay_mode="uniform", beta=0.9)
    want = solve_async_sim(DenseOp(p.A), p.b, torch.zeros_like(p.b),
                           p.x_star, action="gs", num_iters=ITERS, tau=TAU,
                           picks=picks, delays=delays, beta=0.9,
                           record_every=REC)
    assert torch.equal(got.x, want.x)
    seq = solve(p, schedule=Schedule(num_iters=ITERS, record_every=REC),
                picks=picks)
    ref_seq = solve_sequential(DenseOp(p.A), p.b, torch.zeros_like(p.b),
                               p.x_star, action="gs", num_iters=ITERS,
                               picks=picks, record_every=REC)
    assert torch.equal(seq.x, ref_seq.x) and not torch.equal(seq.x, got.x)
    with pytest.raises(ValueError, match="delay_generator or delays"):
        solve(p, schedule=sched, picks=picks)
    with pytest.raises(ValueError, match="gs_block"):
        solve(p, schedule=sched, picks=picks, delays=delays, gs_block=8)


def test_delay_streams():
    gen = torch.Generator().manual_seed(0)
    fixed = draw_delays(50, 4, read_model="consistent", delay_mode="fixed",
                        miss_prob=0.5, generator=None)
    cyc = draw_delays(50, 4, read_model="consistent", delay_mode="cyclic",
                      miss_prob=0.5, generator=None)
    uni = draw_delays(5000, 4, read_model="consistent", delay_mode="uniform",
                      miss_prob=0.5, generator=gen)
    inc = draw_delays(5000, 4, read_model="inconsistent", delay_mode="fixed",
                      miss_prob=0.25, generator=gen)
    assert torch.equal(fixed, torch.full((50,), 4, dtype=torch.int32))
    assert torch.equal(cyc, (torch.arange(50) % 5).to(torch.int32))
    assert set(uni.tolist()) == {0, 1, 2, 3, 4}
    assert inc.shape == (5000, 4) and inc.dtype == torch.bool
    assert abs(float(inc.float().mean()) - 0.25) < 0.02
    with pytest.raises(ValueError, match="delay_generator or delays"):
        draw_delays(8, 4, read_model="consistent", delay_mode="uniform",
                    miss_prob=0.5, generator=None)
    with pytest.raises(ValueError, match="unknown delay_mode"):
        draw_delays(8, 4, read_model="consistent", delay_mode="random",
                    miss_prob=0.5, generator=gen)
    with pytest.raises(ValueError, match="unknown read_model"):
        draw_delays(8, 4, read_model="stale", delay_mode="fixed",
                    miss_prob=0.5, generator=gen)


@pytest.mark.parametrize("delays,mode,match", [
    (torch.full((ITERS,), TAU + 1), "consistent", r"allowed \[0, 6\]"),
    (torch.zeros((ITERS - 1,)), "consistent", "expected"),
    (torch.zeros((ITERS, TAU + 1), dtype=torch.bool), "inconsistent",
     "expected"),
])
def test_given_streams_are_checked(prob, delays, mode, match):
    _, p = prob
    picks = torch.zeros((ITERS,), dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        solve_async_sim(DenseOp(p.A), p.b, torch.zeros_like(p.b), p.x_star,
                        action="gs", num_iters=ITERS, tau=TAU, picks=picks,
                        delays=delays, read_model=mode)
    with pytest.raises(ValueError, match="unknown read_model"):
        solve_async_sim(DenseOp(p.A), p.b, torch.zeros_like(p.b), p.x_star,
                        action="gs", num_iters=ITERS, tau=TAU, picks=picks,
                        delays=delays, read_model="stale")
    with pytest.raises(IndexError, match="pick ids"):
        solve_async_sim(DenseOp(p.A), p.b, torch.zeros_like(p.b), p.x_star,
                        action="gs", num_iters=ITERS, tau=TAU,
                        picks=torch.full((ITERS,), N))
