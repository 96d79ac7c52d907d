"""repro_torch kernel wrappers on the CPU (their plain versions) against the
reference Pallas kernels, run in interpret mode through repro.kernels.ops
as the reference's own tests run them.

Tolerances: sweeps rel ||dx|| <= 1e-5 on x; SpMV rtol 1e-5 / atol 1e-6
(different f32 summation orders).  Within the port, the plain sliced and
prefetch matvecs are bitwise equal, and the band and ELL kernels' plain
versions give a column the same bits whatever rides along.
The CUDA kernels themselves run only on the card (chip_smoke.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import BlockBandedOp as RefBandedOp  # noqa: E402
from repro.core import CsrOp as RefCsrOp  # noqa: E402
from repro.core import EllOp as RefEllOp  # noqa: E402
from repro.core import block_banded_spd as ref_banded_spd  # noqa: E402
from repro.core import random_sparse_lsq as ref_lsq  # noqa: E402
from repro.core import random_sparse_spd as ref_spd  # noqa: E402
from repro.core.engine import sample_rows as ref_sample_rows  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref_banded as ref_ref_banded  # noqa: E402
from repro_torch.core.operators import BlockBandedOp, CsrOp, EllOp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402

from test_torch_operators import CSR_GRID, CSR_IDS, csr_case, to_np  # noqa: E402


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / (np.linalg.norm(want) or 1.0))


def _both(A, rows_per_panel=8):
    return (RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=rows_per_panel),
            CsrOp.from_dense(torch.from_numpy(A),
                             rows_per_panel=rows_per_panel))


def _gs(ref_op, op, b, x, picks, beta, write_base=0):
    want = ref_ops.sweep_rows_gs(*ref_op.padded_rows(), jnp.asarray(b),
                                 jnp.asarray(x), jnp.asarray(picks, jnp.int32),
                                 beta=beta, write_base=write_base,
                                 interpret=True)
    got = ops.sweep_rows_gs(*op.padded_rows(), torch.from_numpy(b),
                            torch.from_numpy(x),
                            torch.tensor(picks, dtype=torch.int64),
                            beta=beta, write_base=write_base)
    return got.numpy(), np.asarray(want)


def _rk(ref_op, op, b, x, picks, beta):
    rn = ref_op.row_norms_sq()
    want = ref_ops.sweep_rows_rk(*ref_op.padded_rows(), jnp.asarray(b), rn,
                                 jnp.asarray(x), jnp.asarray(picks, jnp.int32),
                                 beta=beta, interpret=True)
    got = ops.sweep_rows_rk(*op.padded_rows(), torch.from_numpy(b),
                            torch.from_numpy(np.array(rn)),
                            torch.from_numpy(x),
                            torch.tensor(picks, dtype=torch.int64), beta=beta)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("i,spec", CSR_GRID, ids=CSR_IDS)
def test_sweeps_match_pallas_on_grid(i, spec):
    """GS (square cases) and RK sweeps, 96 sampled picks, beta 0.9."""
    ref_op, op, A = csr_case(spec)
    m, n = A.shape
    rng = np.random.default_rng(i)
    x_star = rng.standard_normal((n, 2)).astype(np.float32)
    b = (A @ x_star).astype(np.float32)
    x0 = np.zeros((n, 2), np.float32)
    if m == n:
        picks = np.asarray(jax.random.randint(jax.random.key(i), (96,), 0, m))
        got, want = _gs(ref_op, op, b, x0, picks, 0.9)
        assert _rel(got, want) <= 1e-5
    picks = np.asarray(ref_sample_rows(jax.random.key(i), ref_op.row_norms_sq(),
                                       96))
    got, want = _rk(ref_op, op, b, x0, picks, 0.9)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("picks", [
    [],                          # empty sweep: a no-op
    [5, 5, 5, 5],                # repeated row (self-coupled updates)
    [12, 12, 0, 5, 12],          # ragged last panel (m=13, R=8) + repeats
    [0, 12, 6, 3, 9, 1],
], ids=["empty", "repeated", "last-panel", "mixed"])
def test_sweeps_degenerate_picks(picks):
    k = 3
    rng = np.random.default_rng(6)
    A = np.array(ref_spd(13, row_nnz=3, seed=5).A)
    b = (A @ rng.standard_normal((13, k))).astype(np.float32)
    x = rng.standard_normal((13, k)).astype(np.float32)
    got, want = _gs(*_both(A), b, x, picks, 0.7)
    assert _rel(got, want) <= 1e-5
    if not picks:
        np.testing.assert_array_equal(got, x)
    L = np.array(ref_lsq(13, 8, row_nnz=3, seed=5).A)
    bl = (L @ rng.standard_normal((8, k))).astype(np.float32)
    xl = rng.standard_normal((8, k)).astype(np.float32)
    got, want = _rk(*_both(L), bl, xl, picks, 0.7)
    assert _rel(got, want) <= 1e-5


def test_gs_sweep_zero_rows_and_write_base():
    """GS picks on all-zero rows move x by beta*b[r]; ``write_base`` shifts
    every write (the slab offset of a distributed local phase)."""
    A = np.array(ref_spd(16, row_nnz=4, seed=7).A)
    A[::5] = 0.0
    ref_op, op = _both(A)
    b = np.ones((16, 2), np.float32)
    x = np.zeros((16, 2), np.float32)
    got, want = _gs(ref_op, op, b, x, [0, 5, 10, 15, 5, 0], 1.0)
    assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(got[5], [2.0, 2.0])
    # a slab of the first 8 rows updating a full-length replica at rows 8..15
    slab = A[:8]
    ref_s, op_s = _both(slab)
    xs = np.random.default_rng(1).standard_normal((16, 2)).astype(np.float32)
    got, want = _gs(ref_s, op_s, b[:8], xs, [0, 7, 3, 7], 0.8, write_base=8)
    assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(got[:8], xs[:8])


def test_rk_sweep_long_stream():
    """A full sampled RK stream (256 steps) stays within 1e-5 of Pallas."""
    L = np.array(ref_lsq(128, 32, row_nnz=6, seed=10).A)
    ref_op, op = _both(L)
    b = (L @ np.random.default_rng(3).standard_normal((32, 2))).astype(
        np.float32)
    picks = np.asarray(ref_sample_rows(jax.random.key(12),
                                       ref_op.row_norms_sq(), 256))
    got, want = _rk(ref_op, op, b, np.zeros((32, 2), np.float32), picks, 0.9)
    assert _rel(got, want) <= 1e-5


def _random_sparse(m, n, row_nnz, seed, *, zero_row_stride=0,
                   zero_panel=None, rows_per_panel=8):
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n), np.float32)
    for i in range(m):
        cols = rng.choice(n, size=min(row_nnz, n), replace=False)
        A[i, cols] = rng.standard_normal(cols.size).astype(np.float32)
    if zero_row_stride:
        A[::zero_row_stride] = 0.0
    if zero_panel is not None:
        A[zero_panel * rows_per_panel:(zero_panel + 1) * rows_per_panel] = 0.0
    return A


@pytest.mark.parametrize("case", [
    dict(m=64, n=64, row_nnz=6, zero_row_stride=3, zero_panel=2,
         rows_per_panel=8),
    dict(m=40, n=24, row_nnz=4, zero_row_stride=5, rows_per_panel=1),
    dict(m=53, n=32, row_nnz=5, rows_per_panel=8),
    dict(m=32, n=96, row_nnz=7, zero_panel=0, rows_per_panel=8),
    dict(m=24, n=16, row_nnz=0, rows_per_panel=8),
    dict(m=1, n=8, row_nnz=3, rows_per_panel=1),
], ids=["zero-panel", "single-row-panels", "ragged-last", "wide-zero-panel",
        "all-zero", "one-row"])
@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_spmv_matches_pallas(case, storage):
    case = dict(case)
    R = case.pop("rows_per_panel")
    A = _random_sparse(**case, seed=11, rows_per_panel=R)
    m, n = A.shape
    ref_op = RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=R,
                                 storage_dtype=storage)
    op = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=R,
                          storage_dtype=storage)
    x = np.random.default_rng(9).standard_normal((n, 3)).astype(np.float32)
    rv, rc = ref_op.sliced_rows()
    want = np.asarray(ref_ops.spmv_csr_sliced(rv, rc, jnp.asarray(x), m=m,
                                              rows_per_panel=R,
                                              interpret=True))
    want_p = np.asarray(ref_ops.spmv_csr_sliced_prefetch(
        rv, rc, ref_op.panel_nnz(), jnp.asarray(x), m=m, rows_per_panel=R,
        interpret=True))
    vals, cols = op.sliced_rows()
    xt = torch.from_numpy(x)
    got = ops.spmv_csr_sliced(vals, cols, xt, m=m, rows_per_panel=R)
    got_p = ops.spmv_csr_sliced_prefetch(vals, cols, op.panel_nnz(), xt, m=m,
                                         rows_per_panel=R)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, got_p)
    np.testing.assert_allclose(got.numpy(), to_np(op.to_dense()) @ x,
                               rtol=1e-4, atol=1e-5)


def test_wrappers_reject_bad_arguments():
    """The checks every wrapper runs before choosing a path."""
    A = np.array(ref_spd(16, row_nnz=3, seed=1).A)
    op = CsrOp.from_dense(torch.from_numpy(A))
    vals, cols = op.padded_rows()
    b = torch.zeros((16, 2))
    x = torch.zeros((16, 2))
    picks = torch.tensor([1, 2])
    with pytest.raises(IndexError, match="pick ids"):
        ops.sweep_rows_gs(vals, cols, b, x, torch.tensor([0, 16]))
    with pytest.raises(IndexError, match="pick ids"):
        ops.sweep_rows_gs(vals, cols, b, x, picks, write_base=15)
    with pytest.raises(TypeError, match="float32"):
        ops.sweep_rows_gs(vals, cols, b.double(), x, picks)
    with pytest.raises(TypeError, match="no kernel for values"):
        ops.sweep_rows_gs(vals, cols.to(torch.int16), b, x, picks)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sweep_rows_rk(vals, cols, b, op.row_norms_sq(),
                          torch.zeros((2, 16)).T, picks)
    with pytest.raises(ValueError, match="do not fit"):
        ops.sweep_rows_rk(vals, cols, b[:8], op.row_norms_sq(), x, picks)
    sv, sc = op.sliced_rows()
    with pytest.raises(ValueError, match="panels"):
        ops.spmv_csr_sliced(sv[:8], sc[:8], x, m=16, rows_per_panel=8)
    with pytest.raises(ValueError, match="panel_nnz"):
        ops.spmv_csr_sliced_prefetch(sv, sc, op.panel_nnz().long(), x, m=16,
                                     rows_per_panel=8)
    # a device with no kernel raises; it is never computed elsewhere
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.spmv_csr_sliced(sv.to("meta"), sc.to("meta"), x.to("meta"),
                            m=16, rows_per_panel=8)


def test_plain_path_counts_no_launches():
    """Only a kernel launch counts; the CPU plain versions do not."""
    ops.reset_launch_counts()
    A = np.array(ref_spd(16, row_nnz=3, seed=1).A)
    op = CsrOp.from_dense(torch.from_numpy(A))
    x = torch.ones((16, 2))
    op.matvec(x)
    op.gs_sweep(torch.ones((16, 2)), x, torch.tensor([3, 4]))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# --- ELL and block-banded kernels -----------------------------------------

@pytest.mark.parametrize("n,row_nnz,width", [(128, 6, 16), (100, 5, 12),
                                             (128, 9, 6)],
                         ids=["tiled", "ragged-n", "truncated"])
@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_spmv_ell_matches_pallas(n, row_nnz, width, storage):
    """ops.spmv_ell (its plain version here) against the reference's
    spmv_ell in interpret mode (n % 128 == 0) or its jnp fallback."""
    A = np.array(ref_spd(n, row_nnz=row_nnz, seed=n).A)
    ref_op = RefEllOp.from_dense(jnp.asarray(A), width=width,
                                 storage_dtype=storage)
    op = EllOp.from_dense(torch.from_numpy(A), width=width,
                          storage_dtype=storage)
    x = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    want = np.asarray(ref_ops.spmv_ell(ref_op.vals, ref_op.cols,
                                       jnp.asarray(x), interpret=True))
    got = ops.spmv_ell(op.vals, op.cols, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), to_np(op.to_dense()) @ x,
                               rtol=1e-4, atol=1e-5)


BAND_CASES = [(8, 1, 1), (16, 2, 3), (32, 1, 5), (8, 3, 2)]
BAND_IDS = [f"block{bl}-bands{bd}-k{k}" for bl, bd, k in BAND_CASES]


def _banded_case(block, bands, k, storage, nb=4):
    n = nb * block
    A = np.array(ref_banded_spd(n, block=block, bands=bands, seed=block).A)
    ref_op = RefBandedOp.from_dense(jnp.asarray(A), block=block, bands=bands,
                                    storage_dtype=storage)
    op = BlockBandedOp.from_dense(torch.from_numpy(A), block=block,
                                  bands=bands, storage_dtype=storage)
    return ref_op, op, A


@pytest.mark.parametrize("block,bands,k", BAND_CASES, ids=BAND_IDS)
@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_bbmv_matches_pallas(block, bands, k, storage):
    """ops.bbmv against the reference's bbmv in interpret mode, bands whose
    block column lies outside the matrix included (bands=3 over 4 block
    rows)."""
    ref_op, op, A = _banded_case(block, bands, k, storage)
    x = np.random.default_rng(k).standard_normal((op.n, k)).astype(
        np.float32)
    want = np.asarray(ref_ops.bbmv(ref_op.A_bands, jnp.asarray(x),
                                   bands=bands, block=block, interpret=True))
    got = ops.bbmv(op.A_bands, torch.from_numpy(x), bands=bands, block=block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), to_np(op.to_dense()) @ x,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("block,bands,k", BAND_CASES, ids=BAND_IDS)
@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_banded_gs_sweep_matches_pallas(block, bands, k, storage):
    """ops.banded_gs_sweep against the reference's kernel in interpret mode
    and its jnp oracle on the same packed tiles, window and picks (repeats
    and both border block rows included), beta 0.9: rel ||dx|| <= 1e-5."""
    ref_op, op, A = _banded_case(block, bands, k, storage)
    rng = np.random.default_rng(block + k)
    b = (A @ rng.standard_normal((op.n, k))).astype(np.float32)
    halo = bands * block
    xw = np.zeros((op.n + 2 * halo, k), np.float32)
    xw[halo:halo + op.n] = rng.standard_normal((op.n, k))
    picks = np.array([0, 3, 3, 1, 2, 0, 3], np.int32)
    args = (jnp.asarray(b), jnp.asarray(xw), jnp.asarray(picks))
    want = np.asarray(ref_ops.banded_gs_sweep(
        ref_op.packed_band_tiles(), *args, block=block, bands=bands, beta=0.9,
        interpret=True))
    oracle = np.asarray(ref_ref_banded.banded_gs_sweep_ref(
        ref_op.packed_band_tiles(), *args, block=block, bands=bands,
        beta=0.9))
    got = ops.banded_gs_sweep(op.packed_band_tiles(), torch.from_numpy(b),
                              torch.from_numpy(xw), torch.from_numpy(picks),
                              block=block, bands=bands, beta=0.9).numpy()
    assert _rel(got, want) <= 1e-5 and _rel(got, oracle) <= 1e-5
    np.testing.assert_array_equal(got[:halo], 0)        # halo untouched
    np.testing.assert_array_equal(got[halo + op.n:], 0)


@pytest.mark.parametrize("kernel", ["bbmv", "banded_gs_sweep", "spmv_ell"])
def test_plain_band_and_ell_kernels_are_column_independent(kernel):
    """Column 0 of a k=5 call equals the k=1 call bitwise: each output is
    summed in one fixed order whatever rides along."""
    _, op, A = _banded_case(16, 2, 5, None)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((op.n, 5)).astype(np.float32))
    if kernel == "bbmv":
        def run(v):
            return ops.bbmv(op.A_bands, v, bands=2, block=16)
    elif kernel == "spmv_ell":
        ell = EllOp.from_dense(torch.from_numpy(A), width=int(
            (A != 0).sum(1).max()))

        def run(v):
            return ops.spmv_ell(ell.vals, ell.cols, v)
    else:
        b = torch.from_numpy(rng.standard_normal((op.n, 5)).astype(
            np.float32))
        picks = torch.tensor([1, 0, 3, 2, 2])

        def run(v):
            xw = torch.nn.functional.pad(v, (0, 0, 32, 32))
            return ops.banded_gs_sweep(op.packed_band_tiles(),
                                       b[:, :v.shape[1]].contiguous(), xw,
                                       picks, block=16, bands=2)
    assert torch.equal(run(x)[:, 0], run(x[:, :1].contiguous())[:, 0])


def test_band_and_ell_wrappers_reject_bad_arguments():
    _, op, A = _banded_case(8, 1, 2, None)
    tiles = op.packed_band_tiles()
    x = torch.zeros((op.n, 2))
    b = torch.zeros((op.n, 2))
    xw = torch.zeros((op.n + 16, 2))
    picks = torch.tensor([0, 3])
    with pytest.raises(ValueError, match="is not"):
        ops.bbmv(tiles, x, bands=2, block=8)
    with pytest.raises(ValueError, match="does not fit"):
        ops.bbmv(tiles, x[:8], bands=1, block=8)
    with pytest.raises(TypeError, match="float32"):
        ops.bbmv(tiles, x.double(), bands=1, block=8)
    with pytest.raises(TypeError, match="no kernel for tiles"):
        ops.bbmv(tiles.half(), x, bands=1, block=8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bbmv(tiles, torch.zeros((2, op.n)).T, bands=1, block=8)
    with pytest.raises(IndexError, match="pick ids"):
        ops.banded_gs_sweep(tiles, b, xw, torch.tensor([0, 4]), block=8,
                            bands=1)
    with pytest.raises(ValueError, match="do not fit"):
        ops.banded_gs_sweep(tiles, b, x, picks, block=8, bands=1)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.bbmv(tiles.to("meta"), x.to("meta"), bands=1, block=8)
    ell = EllOp.from_dense(torch.from_numpy(A), width=8)
    with pytest.raises(ValueError, match="does not fit"):
        ops.spmv_ell(ell.vals, ell.cols, x[:8])
    with pytest.raises(TypeError, match="no kernel for values"):
        ops.spmv_ell(ell.vals, ell.cols.long(), x)


def test_band_and_ell_plain_paths_count_no_launches():
    """The ELL and banded solves on the CPU run the plain versions only."""
    ops.reset_launch_counts()
    _, op, A = _banded_case(8, 1, 2, None)
    b = torch.ones((op.n, 2))
    x = torch.ones((op.n, 2))
    op.matvec(x)
    op.gs_sweep(b, x, torch.tensor([1, 2]))
    ell = EllOp.from_dense(torch.from_numpy(A), width=8)
    ell.matvec(x)
    ell.gs_sweep(b, x, torch.tensor([3, 4]))
    ell.rk_sweep(b, ell.row_norms_sq(), x, torch.tensor([3, 4]))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# --- column sums of the records --------------------------------------------

@pytest.mark.parametrize("n,k", [(1, 1), (100, 3), (1000, 51), (4096, 7)])
def test_colsum_matches_reference_record_sum(n, k):
    """ops.colsum (its plain version here) against the reference's record
    sum (``jnp.einsum("nk,nk->k", e, e)``), rtol 1e-5: two f32 orders."""
    e = np.random.default_rng(n + k).standard_normal((n, k)).astype(np.float32)
    want = np.asarray(jnp.einsum("nk,nk->k", jnp.asarray(e), jnp.asarray(e)))
    t = torch.from_numpy(e)
    got = ops.colsum(t * t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert torch.equal(got, ops.colsum((t * t).contiguous()))


@pytest.mark.parametrize("n", [1, 7, 100, 4096, 16385])
@pytest.mark.parametrize("k", [2, 51])
def test_colsum_plain_column_equals_solo_bitwise(n, k):
    """The plain version's column j of an (n, k) tensor is the solo
    (n, 1) sum bitwise: a column's sum does not depend on k."""
    t = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, k)).astype(np.float32))
    full = ops.colsum(t)
    assert torch.equal(full, port_ref.colsum_ref(t))
    for j in (0, k // 2, k - 1):
        solo = ops.colsum(t[:, j:j + 1].contiguous())
        assert solo.shape == (1,)
        assert torch.equal(solo[0], full[j])


def test_colsum_rejects_bad_arguments():
    with pytest.raises(ValueError, match="2-D"):
        ops.colsum(torch.ones(5))
    with pytest.raises(TypeError, match="float32"):
        ops.colsum(torch.ones((5, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.colsum(torch.ones((2, 5)).T)
    assert ops.colsum(torch.ones((0, 3))).tolist() == [0.0, 0.0, 0.0]
    ops.reset_launch_counts()
    ops.colsum(torch.ones((4, 2)))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
