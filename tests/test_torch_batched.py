"""repro_torch's serving unit (``sequential_chunk``, ``solve_batched``)
against the reference's, and within the port.

Both packages get the same matrix, the same RHS block (numpy, from a
seed) and the same direction stream (the reference's ``draw_picks`` for
its key, handed to the port as ``picks=``).  Each column's tolerance lies
midway (geometric mean) between a reference record residual that sets a
new low and the lowest one before it (the consecutive records when the
residuals fall), so no record sits near a tolerance and the
first-convergence counts are not ambiguous.  Tolerances: x and the final resid within rtol
1e-5 (relative norm, the reference's own fused-vs-scan budget,
tests/test_sweep_kernels.py); ``rounds``, ``converged`` and ``iters_run``
equal.  Within the port, chained chunks are bitwise ``solve_sequential``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import as_operator as ref_as_operator  # noqa: E402
from repro.core import random_sparse_lsq as ref_lsq  # noqa: E402
from repro.core import random_sparse_spd as ref_spd  # noqa: E402
from repro.core.engine import draw_picks as ref_draw_picks  # noqa: E402
from repro.core.engine import solve_batched as ref_solve_batched  # noqa: E402
from repro.core.spd import block_banded_spd as ref_banded_spd  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import (sequential_chunk,  # noqa: E402
                                     solve_batched, solve_sequential)
from repro_torch.core.operators import as_operator  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ITERS, REC, K = 512, 64, 3
RTOL = 1e-5
# (action, format, operator keywords, which problem); a banded GS pick
# solves a whole block row of 8, so its chunks take fewer picks
CASES = [
    ("gs", "csr", dict(rows_per_panel=8), "spd"),
    ("gs", "ell", dict(width=16), "spd"),
    ("gs", "dense", {}, "spd"),
    ("gs", "banded", dict(block=8, bands=2), "banded"),
    ("rk", "csr", dict(rows_per_panel=8), "lsq"),
    ("rk", "dense", {}, "lsq"),
]
BANDED_ITERS, BANDED_REC = 32, 4
IDS = [f"{a}-{f}" for a, f, _, _ in CASES]


@functools.lru_cache(maxsize=None)
def _matrix(kind):
    if kind == "spd":
        return np.asarray(ref_spd(64, row_nnz=6, seed=0).A)
    if kind == "banded":
        return np.asarray(ref_banded_spd(64, block=8, bands=2, seed=1).A)
    return np.asarray(ref_lsq(128, 32, row_nnz=6, seed=2).A)


def _schedule(kind):
    return (BANDED_ITERS, BANDED_REC) if kind == "banded" else (ITERS, REC)


def _setup(action, fmt, kw, kind, k=K, seed=3):
    """(reference op, port op, numpy RHS, port picks, reference key)."""
    A = _matrix(kind)
    ref_op = ref_as_operator(jnp.asarray(A), fmt, **kw)
    op = as_operator(torch.from_numpy(A.copy()), fmt, **kw)
    b = np.random.default_rng(seed).standard_normal(
        (A.shape[0], k)).astype(np.float32)
    key = jax.random.key(seed)
    picks = torch.from_numpy(np.array(ref_draw_picks(ref_op, action, key,
                                                     _schedule(kind)[0])))
    return ref_op, op, b, picks, key


def _records(ref_op, b, action, key, iters, rec):
    """The reference's residual at every record point, (chunks, k)."""
    seen = []

    def on_record(c, x, resid, conv):
        seen.append(np.asarray(resid))
        return True
    ref_solve_batched(ref_op, jnp.asarray(b), action=action, key=key,
                      num_iters=iters, record_every=rec, tol=0.0,
                      on_record=on_record)
    return np.stack(seen)


def _midway_tols(recs):
    """Per column, a tolerance midway (geometric mean) between a record
    that sets a new low and the lowest record before it, so the column
    first converges at that record: the first such record for column 0,
    the last for column 1, one between for column 2.  Every record lies
    at least 1e-3 (relative) away from its column's tolerance."""
    tol = []
    for j in range(recs.shape[1]):
        lows = [t for t in range(1, recs.shape[0])
                if recs[t, j] < 0.99 * recs[:t, j].min()]
        t = lows[(0, -1, len(lows) // 2)[j % 3]]
        tol.append(np.sqrt(recs[:t, j].min() * recs[t, j]))
    tol = np.array(tol, np.float32)
    assert (np.abs(np.log(recs / tol[None, :])) > 1e-3).all()
    return tol


@pytest.mark.parametrize("mode", ["early-exit", "cap"])
@pytest.mark.parametrize("action,fmt,kw,kind", CASES, ids=IDS)
def test_solve_batched_matches_reference(action, fmt, kw, kind, mode):
    ref_op, op, b, picks, key = _setup(action, fmt, kw, kind)
    iters, rec = _schedule(kind)
    recs = _records(ref_op, b, action, key, iters, rec)
    tol = _midway_tols(recs)
    if mode == "cap":
        tol[2] = 0.0            # never met: the solve runs every chunk
    want = ref_solve_batched(ref_op, jnp.asarray(b), action=action, key=key,
                             num_iters=iters, record_every=rec, tol=tol)
    got = solve_batched(op, torch.from_numpy(b), action=action,
                        num_iters=iters, record_every=rec, tol=tol,
                        picks=picks)
    x_want = np.asarray(want.x)
    assert (np.linalg.norm(got.x.numpy() - x_want)
            <= RTOL * np.linalg.norm(x_want))
    np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid),
                               rtol=RTOL)
    np.testing.assert_array_equal(got.rounds.numpy(),
                                  np.asarray(want.rounds))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert got.iters_run == want.iters_run
    assert got.iters_run == (iters if mode == "cap" else
                             int(np.asarray(want.rounds).max()) * rec)
    assert len(set(got.rounds.tolist())) > 1
    assert got.rounds.dtype == torch.int32 and got.converged.dtype == \
        torch.bool


@pytest.mark.parametrize("action,fmt,kw,kind", CASES, ids=IDS)
def test_chained_chunks_bitwise_solve_sequential(action, fmt, kw, kind):
    """Chaining ``sequential_chunk`` over consecutive slices of one stream
    gives bitwise ``solve_sequential``'s final x and its record resids."""
    _, op, b, picks, _ = _setup(action, fmt, kw, kind)
    iters, rec = _schedule(kind)
    b = torch.from_numpy(b)
    n_x = op.shape[0] if action == "gs" else op.shape[1]
    x = torch.zeros((n_x, K))
    one = solve_sequential(op, b, x, None, action=action, num_iters=iters,
                           picks=picks, record_every=rec)
    resids = []
    for c in range(iters // rec):
        x, resid = sequential_chunk(op, b, x, picks[c * rec:(c + 1) * rec],
                                    action=action)
        resids.append(resid)
    assert torch.equal(x, one.x)
    assert torch.equal(torch.stack(resids), one.resid)


def test_solve_batched_dense_block_gs_chunks():
    """Dense block GS (``block > 1``) chains like ``solve_sequential``."""
    _, op, b, _, _ = _setup("gs", "dense", {}, "banded")
    blocks = torch.randint(0, 64 // 8, (ITERS // 8,),
                           generator=torch.Generator().manual_seed(0))
    b = torch.from_numpy(b)
    one = solve_sequential(op, b, torch.zeros_like(b), None, action="gs",
                           num_iters=ITERS // 8, picks=blocks, block=8,
                           record_every=REC // 8)
    got = solve_batched(op, b, action="gs", num_iters=ITERS // 8,
                        record_every=REC // 8, tol=0.0, picks=blocks,
                        block=8)
    assert torch.equal(got.x, one.x)
    assert torch.equal(got.resid, one.resid[-1])
    assert got.iters_run == ITERS // 8 and not got.converged.any()


@pytest.mark.parametrize("action", ["gs", "rk"])
def test_each_chunk_is_one_sweep_one_matvec_one_colsum(action, monkeypatch):
    """A CSR chunk is one call of the sweep wrapper, one of the matvec and
    one of ``colsum`` (three launches on the card), on that chunk's slice
    of the stream, drawn once as contiguous int32."""
    calls = {}

    def spy(name):
        real = getattr(ops, name)

        def wrapped(*args, **kw):
            calls.setdefault(name, []).append(args)
            return real(*args, **kw)
        monkeypatch.setattr(ops, name, wrapped)
    sweep = f"sweep_rows_{action}"
    for name in (sweep, "spmv_csr_sliced", "colsum"):
        spy(name)
    kind = "spd" if action == "gs" else "lsq"
    _, op, b, _, _ = _setup(action, "csr", {}, kind)
    gen = torch.Generator().manual_seed(4)
    picks = engine.draw_picks(op, action, ITERS, generator=gen)
    res = solve_batched(op, torch.from_numpy(b), action=action,
                        num_iters=ITERS, record_every=REC, tol=0.0,
                        generator=torch.Generator().manual_seed(4))
    chunks = ITERS // REC
    assert res.iters_run == ITERS
    assert {n: len(v) for n, v in calls.items()} == {
        sweep: chunks, "spmv_csr_sliced": chunks, "colsum": chunks}
    seen = [args[-1] for args in calls[sweep]]
    assert all(p.dtype == torch.int32 and p.is_contiguous() for p in seen)
    assert torch.equal(torch.cat(seen), picks.to(torch.int32))


def test_rk_row_norms_once_per_solve(monkeypatch):
    """RK's divisor is computed once per solve, not once per chunk."""
    _, op, b, picks, _ = _setup("rk", "csr", {}, "lsq")
    count = []
    real = op.row_norms_sq
    monkeypatch.setattr(op, "row_norms_sq",
                        lambda: count.append(1) or real())
    solve_batched(op, torch.from_numpy(b), action="rk", num_iters=ITERS,
                  record_every=REC, tol=0.0, picks=picks)
    assert len(count) == 1


def test_solve_batched_argument_checks():
    _, op, b, picks, _ = _setup("gs", "csr", {}, "spd")
    b = torch.from_numpy(b)
    with pytest.raises(ValueError, match=r"100.*must be divisible.*32"):
        solve_batched(op, b, action="gs", num_iters=100, record_every=32,
                      tol=0.0, picks=picks[:100])
    with pytest.raises(ValueError, match="num_iters must be > 0"):
        solve_batched(op, b, action="gs", num_iters=0, tol=0.0)
    with pytest.raises(ValueError, match="needs a generator or picks"):
        solve_batched(op, b, action="gs", num_iters=64, tol=0.0)
    with pytest.raises(ValueError, match="picks has shape"):
        solve_batched(op, b, action="gs", num_iters=64, tol=0.0,
                      picks=picks)
    bad = picks[:64].clone()
    bad[3] = 64
    with pytest.raises(IndexError, match="pick ids span"):
        solve_batched(op, b, action="gs", num_iters=64, tol=0.0, picks=bad)
    with pytest.raises(ValueError, match="unknown action"):
        solve_batched(op, b, action="cg", num_iters=64, tol=0.0,
                      picks=picks[:64])
    with pytest.raises(ValueError, match="Gauss-Seidel granularity"):
        solve_batched(op, b, action="rk", num_iters=64, tol=0.0,
                      picks=picks[:64], block=8)


def test_on_record_stops_and_sees_each_chunk():
    """``on_record`` sees every record point in order with host ``conv``;
    returning False stops the solve after that chunk; a scalar tol
    broadcasts over the columns."""
    _, op, b, picks, _ = _setup("gs", "csr", {}, "spd")
    seen = []

    def on_record(c, x, resid, conv):
        seen.append((c, conv.device.type, tuple(resid.shape)))
        return c < 2
    res = solve_batched(op, torch.from_numpy(b), action="gs",
                        num_iters=ITERS, record_every=REC, tol=0.0,
                        picks=picks, on_record=on_record)
    assert seen == [(c, "cpu", (K,)) for c in range(3)]
    assert res.iters_run == 3 * REC
    assert res.rounds.tolist() == [3] * K
