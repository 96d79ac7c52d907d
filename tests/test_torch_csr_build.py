"""The CSR operator build of repro_torch (``CsrOp.from_dense`` and
``CsrOp._assemble``, torch ops on the matrix's device) against the
reference's numpy build (``repro.core.CsrOp.from_dense``): every array and
scalar of the layout equal, on ragged patterns with empty rows, empty
panels and an empty panel 0, row counts that are no multiple of the panel,
rows_per_panel 1 and 8, an all-zero matrix, and bf16 storage with int16
indices (values that round to 0 in bf16 included); ``_assemble`` taking
tensor, numpy and list counts alike; and the build reading no array back
to the host.

Tolerances: none; every comparison is exact.  On the card
``chip_smoke.py`` holds the build there to this CPU build.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CsrOp as RefCsrOp  # noqa: E402
from repro_torch.core.operators import CsrOp  # noqa: E402

ARRAYS = ("data", "indices", "row_id", "row_start", "row_nnz")
SCALARS = ("shape", "nnz", "row_cap", "rows_per_panel", "panel_width")


def _dense(kind, m, n, seed=0):
    """(m, n) f32: ``ragged`` rows of 0 to min(n, 30) nonzeros at distinct
    columns with rows 8-15 and every 5th row zeroed; ``empty0`` that with
    rows 0-7 zeroed too; ``zero`` no nonzero; ``tiny`` ragged with values
    that round to 0 in bf16 (1e-44 and -1e-44, f32 subnormals below the
    smallest bf16 subnormal)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n), np.float32)
    if kind == "zero":
        return A
    for r in range(m):
        cnt = rng.integers(0, min(n, 30) + 1)
        A[r, rng.choice(n, cnt, replace=False)] = rng.standard_normal(cnt)
    A[8:16] = 0.0
    A[4::5] = 0.0
    if kind == "empty0":
        A[:8] = 0.0
    if kind == "tiny":
        nz = np.argwhere(A != 0)
        pick = nz[rng.choice(len(nz), min(len(nz), 7), replace=False)]
        A[pick[:, 0], pick[:, 1]] = np.where(np.arange(len(pick)) % 2,
                                             1e-44, -1e-44)
    return A


CASES = [(kind, m, n, R, storage)
         for kind, m, n in (("ragged", 53, 80), ("ragged", 16, 40),
                            ("ragged", 3, 5), ("empty0", 29, 60),
                            ("zero", 11, 7), ("tiny", 37, 45))
         for R in (1, 8) for storage in (None, "bfloat16")]


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind,m,n,R,storage", CASES)
def test_build_equals_the_reference(kind, m, n, R, storage):
    A = _dense(kind, m, n)
    op = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=R,
                          storage_dtype=storage)
    ref = RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=R,
                              storage_dtype=storage)
    for f in ARRAYS:
        got, want = getattr(op, f), _ref_bits(getattr(ref, f))
        assert str(got.dtype).removeprefix("torch.") == \
            np.asarray(getattr(ref, f)).dtype.name, f
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(_bits(got), want, err_msg=f)
    for f in SCALARS:
        assert getattr(op, f) == getattr(ref, f), f
    np.testing.assert_array_equal(op.panel_nnz().numpy(),
                                  np.asarray(ref.panel_nnz()))
    assert op.panel_nnz().dtype == torch.int32
    per_panel = np.asarray(ref.panel_nnz())
    assert op._has_empty_panel == bool((per_panel == 0).any())
    assert op._panel0_tail == bool(per_panel.size
                                   and per_panel[0] < ref.panel_width)
    if storage is not None:
        assert op.indices.dtype == torch.int16
    if kind == "tiny" and storage is not None:
        # stored entries whose bf16 value is 0 stay stored: the pattern
        # comes from the input before the values are rounded
        assert op.nnz == int((A != 0).sum())
        assert int((op.data == 0).sum()) > op.data.numel() - op.nnz


@pytest.mark.parametrize("counts_as", ["tensor", "numpy", "list"])
@pytest.mark.parametrize("R", [1, 8])
def test_assemble_takes_counts_of_any_kind(counts_as, R):
    """``_assemble`` (the path of hand-made windows: the probe's and the
    smoke run's bf16/int32 operator) gives the from_dense layout whatever
    container holds the counts."""
    A = _dense("ragged", 29, 50, seed=3)
    want = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=R)
    counts = (A != 0).sum(1)
    cap = max(int(counts.max()), 1)
    row_vals = np.zeros((29, cap), np.float32)
    row_cols = np.zeros((29, cap), np.int32)
    for r in range(29):
        cj = np.nonzero(A[r])[0]
        row_vals[r, :cj.size], row_cols[r, :cj.size] = A[r, cj], cj
    given = {"tensor": torch.from_numpy(counts),
             "numpy": counts.astype(np.int64),
             "list": counts.tolist()}[counts_as]
    got = CsrOp._assemble(torch.from_numpy(row_vals),
                          torch.from_numpy(row_cols), given, shape=A.shape,
                          rows_per_panel=R)
    for f in ARRAYS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in SCALARS:
        assert getattr(got, f) == getattr(want, f), f


def test_build_reads_no_array_back(monkeypatch):
    """The build and ``panel_nnz()`` copy no tensor to the host: no
    ``.cpu()``, ``.numpy()``, ``.item()`` or ``int()``.  The build reads
    its three scalars in one ``.tolist()``, ``panel_nnz()`` its two flags
    in one more."""
    A = torch.from_numpy(_dense("empty0", 53, 80))

    def refuse(self, *args, **kwargs):
        raise AssertionError("an array read back to the host")

    reads = []
    tolist = torch.Tensor.tolist

    def counted(self):
        reads.append(self.numel())
        return tolist(self)

    for name in ("cpu", "numpy", "item", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    op = CsrOp.from_dense(A, rows_per_panel=8, storage_dtype="bfloat16")
    assert reads == [3]
    op.panel_nnz()
    op.segsum_rows()
    monkeypatch.undo()
    assert reads == [3, 2]
    assert op._has_empty_panel and op._panel0_tail
