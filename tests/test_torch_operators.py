"""repro_torch operators against the reference (repro.core.operators), over
the CSR, ELL and block-banded cases of the reference's conformance grid
(tests/test_operators.py GRID, bf16 storage and zero rows included).

Layout arrays, the derived views the kernels read and the index dtype are
compared exactly; values computed by both packages within rtol 1e-5 /
atol 1e-6 (different f32 summation orders).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import as_operator as ref_as_operator  # noqa: E402
from repro.core import block_banded_spd as ref_banded_spd  # noqa: E402
from repro.core import random_sparse_lsq as ref_lsq  # noqa: E402
from repro.core import random_sparse_spd as ref_spd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import operators  # noqa: E402
from repro_torch.core.operators import (BlockBandedOp, CsrOp, DenseOp,  # noqa: E402
                                        EllOp, as_operator)
from repro_torch.kernels import ops  # noqa: E402

from test_operators import GRID  # noqa: E402

CSR_GRID = [(i, spec) for i, (fmt, spec) in enumerate(GRID) if fmt == "csr"]
CSR_IDS = [f"csr-{i}" for i, _ in CSR_GRID]


def dense_case(spec) -> np.ndarray:
    """The dense f32 matrix of a GRID case, built as tests/test_operators.py
    builds it (before any storage rounding)."""
    if spec["kind"] == "spd":
        A = np.array(ref_spd(spec["n"], row_nnz=spec["row_nnz"],
                             seed=spec["seed"]).A)
    else:
        A = np.array(ref_lsq(spec["m"], spec["n"], row_nnz=spec["row_nnz"],
                             seed=spec["seed"]).A)
    if spec.get("zero_rows"):
        A = A * (np.arange(A.shape[0]) % 3 != 0)[:, None].astype(np.float32)
    return A


def csr_case(spec):
    """(reference CsrOp, port CsrOp on the CPU, dense f32 matrix)."""
    A = dense_case(spec)
    sd = spec.get("storage_dtype")
    ref_op = ref_as_operator(jnp.asarray(A), "csr", rows_per_panel=8,
                             storage_dtype=sd)
    op = as_operator(torch.from_numpy(A), "csr", rows_per_panel=8,
                     storage_dtype=sd)
    return ref_op, op, A


def to_np(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy, bf16 widened to f32 (exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def ref_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("i,spec", CSR_GRID, ids=CSR_IDS)
def test_csr_layout_equals_reference(i, spec):
    ref_op, op, _ = csr_case(spec)
    pairs = [(op.data, ref_op.data), (op.indices, ref_op.indices),
             (op.row_id, ref_op.row_id), (op.row_start, ref_op.row_start),
             (op.row_nnz, ref_op.row_nnz),
             (op.padded_rows()[0], ref_op.padded_rows()[0]),
             (op.padded_rows()[1], ref_op.padded_rows()[1]),
             (op.sliced_rows()[0], ref_op.sliced_rows()[0]),
             (op.sliced_rows()[1], ref_op.sliced_rows()[1]),
             (op.panel_nnz(), ref_op.panel_nnz())]
    for got, want in pairs:
        assert got.shape == np.asarray(want).shape
        np.testing.assert_array_equal(to_np(got), ref_np(want))
    assert str(op.indices.dtype).removeprefix("torch.") == \
        np.asarray(ref_op.indices).dtype.name
    assert str(op.data.dtype).removeprefix("torch.") == \
        np.asarray(ref_op.data).dtype.name
    assert (op.shape, op.nnz, op.row_cap, op.rows_per_panel,
            op.panel_width) == (ref_op.shape, ref_op.nnz, ref_op.row_cap,
                                ref_op.rows_per_panel, ref_op.panel_width)


@pytest.mark.parametrize("i,spec", CSR_GRID, ids=CSR_IDS)
def test_csr_values_match_reference(i, spec):
    ref_op, op, _ = csr_case(spec)
    m, n = op.shape
    x = np.random.default_rng(i).standard_normal((n, 3)).astype(np.float32)
    want = np.asarray(ref_op.matvec_ref(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    vals, cols = op.sliced_rows()
    R = op.rows_per_panel
    for got in (op.matvec(xt), op.matvec_ref(xt),
                ops.spmv_csr_sliced(vals, cols, xt, m=m, rows_per_panel=R),
                ops.spmv_csr_sliced_prefetch(vals, cols, op.panel_nnz(), xt,
                                             m=m, rows_per_panel=R)):
        assert got.dtype == torch.float32 and got.shape == (m, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    rn = op.row_norms_sq()
    assert rn.dtype == torch.float32
    np.testing.assert_allclose(rn.numpy(), np.asarray(ref_op.row_norms_sq()),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(to_np(op.to_dense()),
                                  ref_np(ref_op.to_dense()))
    # one-pick sweeps against the reference's per-step row actions
    b = np.random.default_rng(i + 1).standard_normal((m, 3)).astype(
        np.float32)
    bt = torch.from_numpy(b)
    if m == n:
        for r in (0, m // 2, m - 1):
            want = x.copy()
            want[r] += 0.7 * (b[r] - np.asarray(
                ref_op.row_dot(r, jnp.asarray(x))))
            got = op.gs_sweep(bt, xt, torch.tensor([r]), beta=0.7)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)
        return
    xr = np.random.default_rng(i + 2).standard_normal((n, 3)).astype(
        np.float32)
    rn_ref = np.asarray(ref_op.row_norms_sq())
    for r in (1, m - 2):
        assert rn_ref[r] > 0
        g = (b[r] - np.asarray(ref_op.row_dot(r, jnp.asarray(xr)))) / rn_ref[r]
        want = np.asarray(ref_op.rk_update(jnp.asarray(xr), r,
                                           jnp.asarray(g), 0.7))
        got = op.rk_sweep(bt, rn, torch.from_numpy(xr), torch.tensor([r]),
                          beta=0.7)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_csr_from_reference_arrays():
    """convert.csr_from_arrays rebuilds the reference operator exactly and
    rejects a layout that would send a kernel out of bounds."""
    _, spec = CSR_GRID[-1]                       # bf16, int16 indices
    ref_op, op, _ = csr_case(spec)
    leaves = [np.asarray(a) for a in (ref_op.data, ref_op.indices,
                                      ref_op.row_id, ref_op.row_start,
                                      ref_op.row_nnz)]
    layout = dict(shape=ref_op.shape, nnz=ref_op.nnz, row_cap=ref_op.row_cap,
                  rows_per_panel=ref_op.rows_per_panel,
                  panel_width=ref_op.panel_width)
    got = convert.csr_from_arrays(*leaves, **layout, device="cpu")
    assert got.data.dtype == torch.bfloat16
    assert got.indices.dtype == torch.int16
    for a, b in zip(got.sliced_rows() + got.padded_rows(),
                    op.sliced_rows() + op.padded_rows()):
        assert torch.equal(a, b)
    bad = leaves[1].copy()
    bad[0] = ref_op.shape[1]
    with pytest.raises(ValueError, match="column ids"):
        convert.csr_from_arrays(leaves[0], bad, *leaves[2:], **layout,
                                device="cpu")


def test_matvec_dispatch_follows_empty_panels(monkeypatch):
    """The predicated kernel runs iff the stored pattern has an empty
    panel, and then equals the plain sliced kernel bitwise."""
    calls = []
    for name in ("spmv_csr_sliced", "spmv_csr_sliced_prefetch"):
        real = getattr(operators.ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(operators.ops, name, spy)
    A = dense_case(dict(kind="spd", n=64, row_nnz=6, seed=6))
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32))
    full = CsrOp.from_dense(torch.from_numpy(A))
    full.matvec(x)
    A[8:16] = 0.0                                # one whole empty panel
    holed = CsrOp.from_dense(torch.from_numpy(A))
    y = holed.matvec(x)
    assert calls == ["spmv_csr_sliced", "spmv_csr_sliced_prefetch"]
    vals, cols = holed.sliced_rows()
    assert torch.equal(y, ops.spmv_csr_sliced(vals, cols, x, m=64,
                                              rows_per_panel=8))
    assert not y[8:16].any()


def test_as_operator_formats():
    A = dense_case(dict(kind="lsq", m=96, n=32, row_nnz=5, seed=7))
    At = torch.from_numpy(A)
    dense = as_operator(At)
    assert isinstance(dense, DenseOp) and dense.shape == (96, 32)
    x = torch.ones((32, 2))
    np.testing.assert_allclose(dense.matvec(x).numpy(), A @ np.ones((32, 2)),
                               rtol=1e-5, atol=1e-5)
    assert as_operator(At, storage_dtype="bfloat16").A.dtype == torch.bfloat16
    assert as_operator(At, "csr", storage_dtype=torch.bfloat16
                       ).data.dtype == torch.bfloat16
    S = torch.from_numpy(dense_case(dict(kind="spd", n=64, row_nnz=6,
                                         seed=6)))
    ell = as_operator(S, "ell", width=9, storage_dtype="bfloat16")
    assert isinstance(ell, EllOp) and ell.vals.shape == (64, 9)
    assert (ell.vals.dtype, ell.cols.dtype) == (torch.bfloat16, torch.int16)
    banded = as_operator(S, "banded", block=16, bands=1)
    assert isinstance(banded, BlockBandedOp)
    assert banded.A_bands.shape == (4, 3, 16, 16) and banded.shape == (64, 64)
    with pytest.raises(ValueError, match="unknown operator format"):
        as_operator(At, "coo")
    with pytest.raises(ValueError, match="unknown storage_dtype"):
        as_operator(At, "csr", storage_dtype="float16")


def test_dense_op_matches_reference():
    A = dense_case(dict(kind="lsq", m=64, n=16, row_nnz=3, seed=8))
    ref_op = ref_as_operator(jnp.asarray(A), "dense")
    op = as_operator(torch.from_numpy(A), "dense")
    np.testing.assert_allclose(op.row_norms_sq().numpy(),
                               np.asarray(ref_op.row_norms_sq()), rtol=1e-6)
    x = jax.random.normal(jax.random.key(0), (16, 2))
    xt = torch.from_numpy(np.array(x))
    b = jax.random.normal(jax.random.key(1), (64, 2))
    g = (b[5] - ref_op.row_dot(5, x)) / ref_op.row_norms_sq()[5]
    want = np.asarray(ref_op.rk_update(x, 5, g, 0.9))
    got = op.rk_sweep(torch.from_numpy(np.array(b)), op.row_norms_sq(), xt,
                      torch.tensor([5]), beta=0.9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


BAND_ELL_GRID = [(fmt, i, spec) for i, (fmt, spec) in enumerate(GRID)
                 if fmt in ("banded", "ell")]
BAND_ELL_IDS = [f"{fmt}-{i}" for fmt, i, _ in BAND_ELL_GRID]


def band_ell_case(fmt, spec):
    """(reference operator, port operator on the CPU, dense f32 matrix) of
    a banded or ELL GRID case, built as tests/test_operators.py builds it."""
    if spec["kind"] == "banded":
        A = np.array(ref_banded_spd(spec["n"], block=spec["block"],
                                    bands=spec["bands"], seed=spec["seed"]).A)
        if spec.get("zero_rows"):
            A = A * (np.arange(A.shape[0]) % 3 != 0)[:, None].astype(
                np.float32)
    else:
        A = dense_case(spec)
    kw = {"storage_dtype": spec.get("storage_dtype")}
    if fmt == "banded":
        kw.update(block=spec["block"], bands=spec["bands"])
    else:
        kw.update(width=spec["width"])
    return (ref_as_operator(jnp.asarray(A), fmt, **kw),
            as_operator(torch.from_numpy(A), fmt, **kw), A)


@pytest.mark.parametrize("fmt,i,spec", BAND_ELL_GRID, ids=BAND_ELL_IDS)
def test_band_and_ell_layout_equals_reference(fmt, i, spec):
    """Stored arrays (values, ids, tiles), their dtypes and the packed
    sweep tiles equal the reference's exactly."""
    ref_op, op, _ = band_ell_case(fmt, spec)
    if fmt == "ell":
        pairs = [(op.vals, ref_op.vals), (op.cols, ref_op.cols),
                 *zip(op.padded_rows(), ref_op.padded_rows())]
    else:
        pairs = [(op.A_bands, ref_op.A_bands),
                 (op.packed_band_tiles(), ref_op.packed_band_tiles())]
        assert (op.nb, op.block, op.width, op.n, op.bands) == (
            ref_op.nb, ref_op.block, ref_op.width, ref_op.n, ref_op.bands)
    for got, want in pairs:
        assert str(got.dtype).removeprefix("torch.") == \
            np.asarray(want).dtype.name
        np.testing.assert_array_equal(to_np(got), ref_np(want))
    assert op.shape == ref_op.shape


@pytest.mark.parametrize("fmt,i,spec", BAND_ELL_GRID, ids=BAND_ELL_IDS)
def test_band_and_ell_values_match_reference(fmt, i, spec):
    """matvec (the plain version of the format's kernel), f32 row norms,
    to_dense, and one-pick sweeps against the reference's row actions."""
    ref_op, op, _ = band_ell_case(fmt, spec)
    n = op.shape[0]
    x = np.random.default_rng(i).standard_normal((n, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    want = np.asarray(ref_op.matvec_ref(jnp.asarray(x)))
    got = op.matvec(xt)
    assert got.dtype == torch.float32 and got.shape == (n, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    rn = op.row_norms_sq()
    assert rn.dtype == torch.float32
    np.testing.assert_allclose(rn.numpy(), np.asarray(ref_op.row_norms_sq()),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(to_np(op.to_dense()),
                                  ref_np(ref_op.to_dense()))
    b = np.random.default_rng(i + 1).standard_normal((n, 3)).astype(
        np.float32)
    bt = torch.from_numpy(b)
    if fmt == "banded":
        for bi in (0, op.nb - 1):
            rows = slice(bi * op.block, (bi + 1) * op.block)
            want = x.copy()
            want[rows] += 0.7 * np.asarray(ref_op.residual_panel(
                jnp.asarray(b), jnp.asarray(x), bi))
            got = op.gs_sweep(bt, xt, torch.tensor([bi]), beta=0.7)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)
        return
    for r in (0, n // 2, n - 1):
        want = x.copy()
        want[r] += 0.7 * (b[r] - np.asarray(ref_op.row_dot(r,
                                                           jnp.asarray(x))))
        got = op.gs_sweep(bt, xt, torch.tensor([r]), beta=0.7)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    rn_ref = np.asarray(ref_op.row_norms_sq())
    for r in (1, n - 2):
        if rn_ref[r] == 0:
            continue
        g = (b[r] - np.asarray(ref_op.row_dot(r, jnp.asarray(x)))) / rn_ref[r]
        want = np.asarray(ref_op.rk_update(jnp.asarray(x), r, jnp.asarray(g),
                                           0.7))
        got = op.rk_sweep(bt, rn, xt, torch.tensor([r]), beta=0.7)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
