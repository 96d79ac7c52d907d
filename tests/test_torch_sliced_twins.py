"""The two sliced CSR matvecs of repro_torch (``spmv_csr_sliced`` and its
empty-panel-predicated twin ``spmv_csr_sliced_prefetch``) are bitwise equal
for finite x only.  On an empty panel the plain twin chains its padding
slots, fmaf(+0, x[0, c], acc), so a NaN or inf in x's row 0 reaches the
panel's rows as NaN (0 * inf is NaN), where the predicated twin writes 0.
These tests pin both behaviours against the reference's Pallas pair
(interpret mode, as the reference's own tests run them), NaN position for
NaN position, and hold the twins bitwise equal on a finite x.

Tolerances: where both packages give a finite value, |port - reference| <=
1e-5 * (|A| |x|) + 1e-6 over x's finite entries (different f32 summation
orders); NaN positions, infinities and the predicated twin's zeros
exactly; the port's twins bitwise.  The
CUDA kernels run only on the card (chip_smoke.py, tune/spmv_probe.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CsrOp as RefCsrOp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core.operators import CsrOp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

R = 8


def _dense(seed):
    """16 x 16 f32 whose panel 0 (rows 0-7) is empty at R = 8; the rows of
    panel 1 hold 1 to 6 nonzeros at distinct columns."""
    rng = np.random.default_rng(seed)
    A = np.zeros((16, 16), np.float32)
    for r in range(R, 16):
        cnt = rng.integers(1, 7)
        A[r, rng.choice(16, cnt, replace=False)] = rng.standard_normal(cnt)
    return A


def _pairs(A, x):
    """(port plain, port predicated, reference plain, reference predicated)
    outputs as numpy."""
    m = A.shape[0]
    op = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=R)
    ref_op = RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=R)
    vals, cols = op.sliced_rows()
    xt = torch.from_numpy(x)
    plain = ops.spmv_csr_sliced(vals, cols, xt, m=m, rows_per_panel=R)
    pred = ops.spmv_csr_sliced_prefetch(vals, cols, op.panel_nnz(), xt, m=m,
                                        rows_per_panel=R)
    rv, rc = ref_op.sliced_rows()
    ref_plain = ref_ops.spmv_csr_sliced(rv, rc, jnp.asarray(x), m=m,
                                        rows_per_panel=R, interpret=True)
    ref_pred = ref_ops.spmv_csr_sliced_prefetch(
        rv, rc, ref_op.panel_nnz(), jnp.asarray(x), m=m, rows_per_panel=R,
        interpret=True)
    assert int(op.panel_nnz()[0]) == 0 == int(ref_op.panel_nnz()[0])
    return plain, pred, np.asarray(ref_plain), np.asarray(ref_pred)


def _close_where_finite(got, want, scale):
    same_nan = np.isnan(got) == np.isnan(want)
    assert same_nan.all(), np.argwhere(~same_nan)
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-5 * scale[fin] + 1e-6)


@pytest.mark.parametrize("special", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("seed", range(3))
def test_nan_in_x_row_0_reaches_an_empty_panel_in_the_plain_twin_only(
        seed, special):
    A = _dense(seed)
    x = np.random.default_rng(seed + 10).standard_normal((16, 3)).astype(
        np.float32)
    x[0, 1] = special
    plain, pred, ref_plain, ref_pred = _pairs(A, x)
    scale = np.abs(A) @ np.where(np.isfinite(x), np.abs(x), 0)
    _close_where_finite(plain.numpy(), ref_plain, scale)
    _close_where_finite(pred.numpy(), ref_pred, scale)
    # panel 0: NaN from the plain twins in column 1, +0 from the predicated
    assert np.isnan(plain.numpy()[:R, 1]).all()
    assert np.isnan(ref_plain[:R, 1]).all()
    assert (pred.numpy()[:R] == 0).all() and (ref_pred[:R] == 0).all()
    assert not np.signbit(pred.numpy()[:R]).any()
    # the other columns and panels: the twins bitwise equal
    finite = torch.ones_like(plain, dtype=torch.bool)
    finite[:R, 1] = False
    bits = torch.int32
    assert torch.equal(plain[finite].view(bits), pred[finite].view(bits))
    assert not torch.equal(plain.view(bits), pred.view(bits))


@pytest.mark.parametrize("seed", range(3))
def test_twins_bitwise_equal_on_finite_x(seed):
    A = _dense(seed)
    x = np.random.default_rng(seed + 20).standard_normal((16, 5)).astype(
        np.float32)
    x[0, 2] = -0.0
    plain, pred, ref_plain, ref_pred = _pairs(A, x)
    assert plain.numpy().tobytes() == pred.numpy().tobytes()
    scale = np.abs(A) @ np.abs(x)
    _close_where_finite(plain.numpy(), ref_plain, scale)
    _close_where_finite(pred.numpy(), ref_pred, scale)
