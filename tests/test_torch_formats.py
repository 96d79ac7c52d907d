"""repro_torch ELL and block-banded formats against the reference: the
generators, the ELL windows, the sequential solves through both formats
(the same direction stream handed to both packages), operators carried
across from the reference, and the port's own bitwise contracts.

Tolerances: matrices, ELL windows and band tiles bitwise; eigenvalues
rtol 1e-4 (different eigensolvers); matvecs rtol 1e-5 / atol 1e-6
(different f32 summation orders); solves the reference's own fused-vs-scan
RK budget (tests/test_sweep_kernels.py): rel ||dx|| <= 1e-5, resid and
err_sq rtol 1e-4 / atol 1e-5.  Within the port, a zero-padded RHS column
leaves the real one bitwise unchanged.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Schedule as RefSchedule  # noqa: E402
from repro.core import as_operator as ref_as_operator  # noqa: E402
from repro.core import solve as ref_solve  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro.core.engine import draw_picks as ref_draw_picks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine, spd  # noqa: E402
from repro_torch.core.engine import Schedule, solve  # noqa: E402
from repro_torch.core.operators import (BlockBandedOp, EllOp,  # noqa: E402
                                        as_operator)


def _to_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _ref_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("side,seed", [(4, 0), (6, 2)])
def test_laplacian_spd_matches_reference(side, seed):
    r = ref_spd.laplacian_spd(side, n_rhs=2, seed=seed)
    p = spd.laplacian_spd(side, n_rhs=2, seed=seed, device="cpu")
    assert p.A.dtype == torch.float32 and p.A.shape == (side ** 2,) * 2
    np.testing.assert_array_equal(p.A.numpy(), np.asarray(r.A))
    np.testing.assert_allclose(float(p.lam_min), float(r.lam_min), rtol=1e-4)
    np.testing.assert_allclose(float(p.lam_max), float(r.lam_max), rtol=1e-4)
    torch.testing.assert_close(p.b, p.A @ p.x_star, rtol=0, atol=0)


@pytest.mark.parametrize("n,block,bands,seed", [(64, 8, 2, 0),
                                                (96, 16, 1, 3),
                                                (128, 32, 2, 5)])
def test_block_banded_spd_matches_reference(n, block, bands, seed):
    r = ref_spd.block_banded_spd(n, block=block, bands=bands, n_rhs=2,
                                 seed=seed)
    p = spd.block_banded_spd(n, block=block, bands=bands, n_rhs=2, seed=seed,
                             device="cpu")
    np.testing.assert_array_equal(p.A.numpy(), np.asarray(r.A))
    np.testing.assert_allclose(float(p.lam_min), float(r.lam_min), rtol=1e-4)
    np.testing.assert_allclose(float(p.lam_max), float(r.lam_max), rtol=1e-4)
    # identity diagonal blocks: each block-GS step solves its block exactly
    diag = p.A.reshape(n // block, block, n // block, block).diagonal(
        dim1=0, dim2=2)
    assert torch.equal(diag, torch.eye(block)[:, :, None].expand_as(diag))
    with pytest.raises(ValueError, match="multiple of block"):
        spd.block_banded_spd(n + 1, block=block, device="cpu")


@pytest.mark.parametrize("kind,width", [
    ("laplacian", 3), ("laplacian", 5), ("laplacian", 25),
    ("sparse", 8), ("sparse", 32)])
def test_ell_windows_equal_reference(kind, width):
    """The windows, ties included: every off-diagonal entry of the
    Laplacian has the same magnitude, and a truncating width keeps the
    lower column ids, as ``lax.top_k`` does."""
    if kind == "laplacian":
        A = ref_spd.laplacian_spd(5, seed=1).A
    else:
        A = ref_spd.random_sparse_spd(64, row_nnz=6, seed=4).A
    want_v, want_c = ref_spd.ell_from_dense(A, width)
    got_v, got_c = spd.ell_from_dense(torch.from_numpy(np.array(A)), width)
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    with pytest.raises(ValueError, match="width"):
        spd.ell_from_dense(torch.from_numpy(np.array(A)), A.shape[0] + 1)


@pytest.mark.parametrize("row_nnz", [0, 5, 40])
def test_ell_default_width_holds_every_nonzero(row_nnz):
    """Left at its default, the ELL width is the largest nonzero count of
    any row (1 for a zero matrix): the operator is exact, also past the
    reference's default width of 32, and its windows equal the
    reference's at that width."""
    rng = np.random.default_rng(row_nnz)
    A = np.zeros((64, 64), np.float32)
    for i in range(64):
        cols = rng.choice(64, size=row_nnz, replace=False)
        A[i, cols] = rng.standard_normal(row_nnz).astype(np.float32) + 2.0
    op = as_operator(torch.from_numpy(A), "ell")
    assert op.width == max(1, row_nnz)
    np.testing.assert_array_equal(op.to_dense().numpy(), A)
    ref_op = ref_as_operator(jnp.asarray(A), "ell", width=op.width)
    np.testing.assert_array_equal(op.vals.numpy(), np.asarray(ref_op.vals))
    np.testing.assert_array_equal(op.cols.numpy(), np.asarray(ref_op.cols))


# (format, problem, storage, action, format arguments)
SOLVES = [
    ("ell", "sparse", None, "gs", dict(width=16)),
    ("ell", "sparse", "bfloat16", "gs", dict(width=16)),
    ("ell", "sparse", None, "rk", dict(width=16)),
    ("ell", "laplacian", None, "gs", dict(width=3)),    # truncated rows
    ("banded", "banded", None, "gs", dict(block=16, bands=1)),
    ("banded", "banded", "bfloat16", "gs", dict(block=16, bands=1)),
    ("banded", "banded2", None, "gs", dict(block=8, bands=2)),
]
SOLVE_IDS = ["ell-gs-f32", "ell-gs-bf16", "ell-rk-f32", "ell-gs-truncated",
             "banded-gs-f32", "banded-gs-bf16", "banded-gs-bands2"]
ITERS, REC = 64, 32


def _problem(kind, k=2):
    """(reference problem, port problem on the CPU) with identical arrays."""
    if kind == "sparse":
        r = ref_spd.random_sparse_spd(64, row_nnz=6, n_rhs=k, seed=6)
    elif kind == "laplacian":
        r = ref_spd.laplacian_spd(6, n_rhs=k, seed=1)
    elif kind == "banded":
        r = ref_spd.block_banded_spd(128, block=16, bands=1, n_rhs=k, seed=2)
    else:
        r = ref_spd.block_banded_spd(64, block=8, bands=2, n_rhs=k, seed=3)
    return r, convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                             r.lam_max, "cpu")


@pytest.mark.parametrize("ref_fused", [False, True], ids=["scan", "fused"])
@pytest.mark.parametrize("fmt,kind,storage,action,kw", SOLVES,
                         ids=SOLVE_IDS)
def test_solve_matches_reference(fmt, kind, storage, action, kw, ref_fused):
    r, p = _problem(kind)
    key = jax.random.key(11)
    ref_op = ref_as_operator(r.A, fmt, storage_dtype=storage, **kw)
    picks = np.array(ref_draw_picks(ref_op, action, key, ITERS))
    want = ref_solve(r, key=key, format=fmt, action=action, beta=0.9,
                     storage_dtype=storage, fused=ref_fused,
                     schedule=RefSchedule(num_iters=ITERS, record_every=REC),
                     **kw)
    got = solve(p, format=fmt, action=action, beta=0.9, storage_dtype=storage,
                picks=torch.from_numpy(picks),
                schedule=Schedule(num_iters=ITERS, record_every=REC), **kw)
    x_want = np.asarray(want.x)
    assert np.linalg.norm(got.x.numpy() - x_want) / np.linalg.norm(
        x_want) <= 1e-5
    for a, b in ((got.resid, want.resid), (got.err_sq, want.err_sq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


def test_banded_sequential_rk_raises():
    _, p = _problem("banded")
    with pytest.raises(NotImplementedError, match="per-row access"):
        solve(p, format="banded", action="rk", block=16, bands=1,
              generator=torch.Generator().manual_seed(0),
              schedule=Schedule(num_iters=16))


def test_banded_picks_are_block_rows():
    """GS picks on the banded format range over the nb block rows; a
    caller's picks are checked against nb, not n."""
    _, p = _problem("banded")
    op = as_operator(p.A, "banded", block=16, bands=1)
    assert engine.num_directions(op, "gs") == op.nb == 8
    picks = engine.draw_picks(op, "gs", 4096,
                              generator=torch.Generator().manual_seed(1))
    assert picks.min() == 0 and picks.max() == op.nb - 1
    sched = Schedule(num_iters=16)
    ok = torch.full((16,), op.nb - 1)
    assert torch.isfinite(solve(p, format="banded", block=16, bands=1,
                                picks=ok, schedule=sched).x).all()
    with pytest.raises(IndexError, match=r"allowed \[0, 8\)"):
        solve(p, format="banded", block=16, bands=1,
              picks=torch.full((16,), op.nb), schedule=sched)


def test_banded_gs_never_increases_the_error():
    """Identity diagonal blocks make each block step exact, so with
    beta = 1 the A-norm error is non-increasing (up to 1e-6 rounding)."""
    _, p = _problem("banded")
    res = solve(p, format="banded", block=16, bands=1,
                generator=torch.Generator().manual_seed(2),
                schedule=Schedule(num_iters=8 * 16, record_every=8))
    err = torch.cat([spd.a_norm_sq(p.A, p.x_star)[None], res.err_sq]).numpy()
    assert (err[1:] <= err[:-1] * (1 + 1e-6)).all()
    assert err[-1].max() < 1e-3 * err[0].min()


@pytest.mark.parametrize("fmt,kw", [("ell", dict(width=16)),
                                    ("banded", dict(block=16, bands=1))])
def test_padded_rhs_column_equals_solo(fmt, kw):
    """A zero-padded RHS column leaves the real column bitwise unchanged
    (sweep, matvec and metrics alike)."""
    _, p1 = _problem("sparse" if fmt == "ell" else "banded", k=1)
    p2 = p1._replace(b=torch.cat([p1.b, torch.zeros_like(p1.b)], 1),
                     x_star=torch.cat([p1.x_star,
                                       torch.zeros_like(p1.x_star)], 1))
    op = as_operator(p1.A, fmt, **kw)
    picks = engine.draw_picks(op, "gs", ITERS,
                              generator=torch.Generator().manual_seed(3))
    sched = Schedule(num_iters=ITERS, record_every=REC)
    solo = solve(p1, format=fmt, picks=picks, schedule=sched, **kw)
    both = solve(p2, format=fmt, picks=picks, schedule=sched, **kw)
    assert torch.equal(both.x[:, :1], solo.x)
    assert not both.x[:, 1].any()
    assert torch.equal(both.err_sq[:, :1], solo.err_sq)
    assert torch.equal(both.resid[:, :1], solo.resid)


@pytest.mark.parametrize("fmt,storage", [("ell", None), ("ell", "bfloat16"),
                                         ("banded", None),
                                         ("banded", "bfloat16")])
def test_operator_carried_across_from_reference(fmt, storage):
    """convert.ell_from_arrays / banded_from_arrays carry a reference
    operator across as numpy; its matvec equals (torch.equal) that of the
    operator the port builds itself, and the reference's within rtol 1e-5
    / atol 1e-6."""
    r, p = _problem("sparse" if fmt == "ell" else "banded")
    kw = dict(width=16) if fmt == "ell" else dict(block=16, bands=1)
    ref_op = ref_as_operator(r.A, fmt, storage_dtype=storage, **kw)
    op = as_operator(p.A, fmt, storage_dtype=storage, **kw)
    if fmt == "ell":
        got = convert.ell_from_arrays(np.asarray(ref_op.vals),
                                      np.asarray(ref_op.cols), device="cpu")
        assert isinstance(got, EllOp)
        assert (got.vals.dtype, got.cols.dtype) == (op.vals.dtype,
                                                    op.cols.dtype)
    else:
        got = convert.banded_from_arrays(np.asarray(ref_op.A_bands),
                                         ref_op.bands, device="cpu")
        assert isinstance(got, BlockBandedOp) and got.nb == op.nb
        assert got.A_bands.dtype == op.A_bands.dtype
    x = np.random.default_rng(5).standard_normal((op.shape[1], 3)).astype(
        np.float32)
    y = got.matvec(torch.from_numpy(x))
    assert torch.equal(y, op.matvec(torch.from_numpy(x)))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(ref_op.matvec_ref(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_to_np(got.to_dense()),
                                  _ref_np(ref_op.to_dense()))


def test_converters_reject_bad_layouts():
    r, _ = _problem("sparse")
    ref_op = ref_as_operator(r.A, "ell", width=8)
    cols = np.array(ref_op.cols)
    cols[3, 2] = cols.shape[0]
    with pytest.raises(ValueError, match="column ids"):
        convert.ell_from_arrays(np.asarray(ref_op.vals), cols, device="cpu")
    with pytest.raises(ValueError, match="equal 2-D shapes"):
        convert.ell_from_arrays(np.asarray(ref_op.vals)[:, :4], cols,
                                device="cpu")
    tiles = np.zeros((4, 3, 8, 8), np.float32)
    assert convert.banded_from_arrays(tiles, 1, device="cpu").shape == (32, 32)
    for bad, bands in ((tiles, 2), (tiles[..., :4], 1), (tiles[0], 1)):
        with pytest.raises(ValueError, match="block, block"):
            convert.banded_from_arrays(bad, bands, device="cpu")
