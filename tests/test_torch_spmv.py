"""The row-window matvecs of repro_torch (``spmv_csr_sliced`` and its
predicated twin, ``spmv_ell``) beyond the main path's k = 51: their plain
versions against the reference's Pallas kernels (interpret mode, as the
reference's own tests run them) with the operators' per-row counts passed;
the counts (``CsrOp.row_counts``, ``EllOp.row_counts``, the rule
``kernels/spmv_csr.py::row_extent``) against the reference layouts'
counts; the wrappers' checks of a counts tensor; the exactness of a chain
stopped after the first padding slot for any x; and the source patches of
``tune/spmv_probe.py``.

Tolerances: against the Pallas kernels |port - reference| <= 1e-5 *
(|A| |x|) + 1e-6 per output, as chip_smoke.py holds the CUDA kernels to
the plain versions (different f32 summation orders of up to 37 terms;
scaled by |A| |x| because a sum that cancels keeps the terms' rounding);
the stopped chain bitwise.  The CUDA kernel itself runs only on the card
(chip_smoke.py, tune/spmv_probe.py).
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CsrOp as RefCsrOp  # noqa: E402
from repro.core import EllOp as RefEllOp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core.operators import CsrOp, EllOp  # noqa: E402
from repro_torch.kernels import ops, spmv_csr  # noqa: E402
from repro_torch.tune import spmv_probe  # noqa: E402

KS = (1, 3, 16, 31, 32, 33, 51, 64, 70)


def _close(got, want, scale):
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-6)


def _ragged(m, n, most, seed):
    """(m, n) f32 with rows of 0 to ``most`` nonzeros at distinct columns
    (and one all-zero panel of 8 rows when m >= 16)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((m, n), np.float32)
    for r in range(m):
        cnt = rng.integers(0, most + 1)
        A[r, rng.choice(n, cnt, replace=False)] = rng.standard_normal(cnt)
    if m >= 16:
        A[8:16] = 0.0
    return A


@pytest.mark.parametrize("k", KS)
def test_row_window_plain_paths_match_pallas(k):
    """The sliced pair and ELL through ops.py (their plain versions here)
    against the reference's kernels at k columns (a warp of the CUDA
    kernel spans one to 32 rows), ragged m, empty panels, a truncated ELL
    width, the operators' counts passed."""
    rng = np.random.default_rng(k)
    for most, m, n in ((20, 53, 40), (37, 29, 60)):
        A = _ragged(m, n, most, seed=k + most)
        x = rng.standard_normal((n, k)).astype(np.float32)
        ref_op = RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=8)
        op = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=8)
        rv, rc = ref_op.sliced_rows()
        want = np.asarray(ref_ops.spmv_csr_sliced(
            rv, rc, jnp.asarray(x), m=m, rows_per_panel=8, interpret=True))
        vals, cols = op.sliced_rows()
        xt = torch.from_numpy(x)
        got = ops.spmv_csr_sliced(vals, cols, xt, m=m, rows_per_panel=8,
                                  counts=op.row_counts())
        got_p = ops.spmv_csr_sliced_prefetch(vals, cols, op.panel_nnz(), xt,
                                             m=m, rows_per_panel=8,
                                             counts=op.row_counts())
        _close(got.numpy(), want, np.abs(A) @ np.abs(x))
        assert torch.equal(got, got_p)
    A = _ragged(64, 64, 20, seed=k)
    x = rng.standard_normal((64, k)).astype(np.float32)
    for width in (None, 12):
        ref_op = RefEllOp.from_dense(jnp.asarray(A), width=width or 20)
        op = EllOp.from_dense(torch.from_numpy(A), width=width)
        want = np.asarray(ref_ops.spmv_ell(ref_op.vals, ref_op.cols,
                                           jnp.asarray(x), interpret=True))
        got = ops.spmv_ell(op.vals, op.cols, torch.from_numpy(x),
                           counts=op.row_counts())
        scale = ops.spmv_ell(op.vals.abs(), op.cols,
                             torch.from_numpy(np.abs(x))).numpy()
        _close(got.numpy(), want, scale)


BAD_COUNTS = {
    "int64": lambda c: c.long(),
    "short": lambda c: c[:-1],
    "2-D": lambda c: c[:, None],
    "strided": lambda c: torch.stack([c, c], 1)[:, 0],
}


@pytest.mark.parametrize("bad", sorted(BAD_COUNTS))
@pytest.mark.parametrize("kernel", ["sliced", "sliced_prefetch", "ell"])
def test_wrappers_reject_a_wrong_count_tensor(kernel, bad):
    """counts must be contiguous int32 of shape (rows,) on x's device."""
    A = _ragged(24, 24, 6, seed=5)
    x = torch.ones((24, 3))
    csr = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=8)
    ell = EllOp.from_dense(torch.from_numpy(A))
    vals, cols = csr.sliced_rows()
    calls = {
        "sliced": lambda c: ops.spmv_csr_sliced(vals, cols, x, m=24,
                                                rows_per_panel=8, counts=c),
        "sliced_prefetch": lambda c: ops.spmv_csr_sliced_prefetch(
            vals, cols, csr.panel_nnz(), x, m=24, rows_per_panel=8,
            counts=c),
        "ell": lambda c: ops.spmv_ell(ell.vals, ell.cols, x, counts=c)}
    good = csr.row_counts() if kernel != "ell" else ell.row_counts()
    assert torch.equal(calls[kernel](good), calls[kernel](None))
    with pytest.raises(ValueError, match="counts must be"):
        calls[kernel](BAD_COUNTS[bad](good))


@pytest.mark.parametrize("storage", [None, "bfloat16"])
@pytest.mark.parametrize("layout", ["csr-R1", "csr-R8", "ell-exact",
                                    "ell-truncated"])
def test_row_extent_equals_reference_layout_counts(layout, storage):
    """row_extent (the slots before a row's trailing run of +0 slots on its
    last slot's column) is each row's count of stored nonzeros in the
    reference's layouts: the CSR sliced view's rows (0 past m), and ELL's
    min(count, width); so are the port's operators' row_counts()."""
    A = _ragged(61, 45, 30, seed=3)
    counts = (A != 0).sum(1)
    if layout.startswith("csr"):
        R = int(layout[-1])
        ref = RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=R,
                                  storage_dtype=storage)
        rv, rc = ref.sliced_rows()
        want = np.zeros(rv.shape[0], np.int32)
        want[:61] = np.asarray(ref.row_nnz)
        assert np.array_equal(want[:61], counts)
    else:
        width = 30 if layout == "ell-exact" else 11
        ref = RefEllOp.from_dense(jnp.asarray(A), width=width,
                                  storage_dtype=storage)
        rv, rc = ref.vals, ref.cols
        want = np.minimum(counts, width)
    vals = torch.from_numpy(np.array(rv.astype(jnp.float32)))
    if storage:
        vals = vals.to(torch.bfloat16)
    cols = torch.from_numpy(np.asarray(rc).astype(np.int32))
    got = spmv_csr.row_extent(vals, cols)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if layout.startswith("csr"):
        op = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=R,
                              storage_dtype=storage)
        mine = op.row_counts()
        assert torch.equal(spmv_csr.row_extent(*op.sliced_rows())[:61], mine)
    else:
        op = EllOp.from_dense(torch.from_numpy(A), width=width,
                              storage_dtype=storage)
        mine = op.row_counts()
    assert mine.dtype == torch.int32
    assert np.array_equal(mine.numpy(), want[:61])


@pytest.mark.parametrize("most,width,k,stops", [
    (12, None, 51, False),            # every row of 12: no padding
    (12, 16, 51, True),               # 4 of 16 slots padding: 25%
    (30, None, 51, True),             # ragged rows of 0 to 30
    (30, None, 2 ** 32 // 64, False),  # 64 rows x k outputs reach 2^32
])
def test_operators_stop_the_matvec_where_padding_pays(most, width, k, stops):
    """stop_counts(k): the operators' counts where at least
    STOP_PADDING_SHARE of the window slots are padding and the rows x k
    outputs fit the stopped kernel's 32-bit index, else None."""
    rng = np.random.default_rng(most)
    A = np.zeros((64, 48), np.float32)
    for r in range(64):
        cnt = most if most == 12 else rng.integers(0, most + 1)
        A[r, rng.choice(48, cnt, replace=False)] = rng.standard_normal(cnt)
    ell = EllOp.from_dense(torch.from_numpy(A), width=width)
    got = ell.stop_counts(k)
    assert (got is not None) == stops
    if stops:
        assert torch.equal(got, ell.row_counts())
    csr = CsrOp.from_dense(torch.from_numpy(A))
    slots = 64 * (-(-csr.row_cap // 8) * 8)
    assert (csr.stop_counts(k) is not None) == spmv_csr.worth_stopping(
        64, slots // 64, csr.nnz, k)
    if k * 64 >= 2 ** 32:
        assert csr.stop_counts(k) is None


@pytest.mark.parametrize("seed", range(4))
def test_chain_stopped_after_the_run_start_is_bitwise_the_full_chain(seed):
    """The exactness the kernel's stop rests on: a row's chain over slots
    [0, extent], the first slot of its trailing run included, gives the
    bits of the chain over every slot, for x holding NaN, inf and -0 too
    (each run slot adds the same signed zero or NaN, and adding it twice
    is adding it once)."""
    rng = np.random.default_rng(seed)
    n, width, k = 12, 16, 5
    vals = np.zeros((40, width), np.float32)
    cols = np.zeros((40, width), np.int32)
    for r in range(40):
        cnt = rng.integers(0, width + 1)
        vals[r, :cnt] = rng.standard_normal(cnt)
        vals[r, :cnt][rng.random(cnt) < 0.2] = 0.0      # stored zeros
        cols[r, :cnt] = rng.integers(0, n, cnt)
        cols[r, cnt:] = r % n if r % 2 else 0           # ELL / CSR padding
    x = rng.standard_normal((n, k)).astype(np.float32)
    x[0, 0], x[1, 1], x[2] = np.nan, np.inf, -0.0
    x[3, :2] = -np.inf
    vt, ct, xt = (torch.from_numpy(a) for a in (vals, cols, x))
    ext = spmv_csr.row_extent(vt, ct)
    for r in range(40):
        full = torch.zeros(k)
        for w in range(width):
            full = full + vt[r, w] * xt[ct[r, w]]
        stop = min(int(ext[r]) + 1, width)
        part = torch.zeros(k)
        for w in range(stop):
            part = part + vt[r, w] * xt[ct[r, w]]
        assert full.numpy().tobytes() == part.numpy().tobytes(), r


@pytest.mark.parametrize("variant", sorted(spmv_probe.VARIANTS))
def test_spmv_probe_patches_the_sources(variant):
    """Each variant of tune/spmv_probe.py finds every line it patches in
    csrc/common.cuh and kernels/spmv_csr.py exactly once; the probe
    refuses a variant it does not know."""
    pkg = Path(spmv_csr.__file__).parents[1]
    src = {path: (pkg / path).read_text()
           for path in (spmv_probe.CUH, spmv_probe.PY)}
    out = spmv_probe.patched(src, variant)
    changed = {path for path in src if out[path] != src[path]}
    assert changed == {path for path, _, _ in spmv_probe.VARIANTS[variant]}
    assert ("acc += g[u];" in out[spmv_probe.CUH]) == (variant == "gather_only")
    assert ("return c < width ? c + 1 : width;" in out[spmv_probe.CUH]) == (
        variant != "all_slots")
    assert ("STOP_PADDING_SHARE = 0.0" in out[spmv_probe.PY]) == (
        variant == "stop_everywhere")
    broken = {path: text.replace("acc = fmaf(v[u]", "acc = h(v[u]")
              .replace("++w) acc = fmaf(", "++w) acc = h(")
              .replace("return c < width ?", "return c <= width ?")
              .replace("STOP_PADDING_SHARE = 0.25", "STOP_PADDING_SHARE = 1")
              .replace("? slot_dot(vals", "? g(vals")
              for path, text in src.items()}
    with pytest.raises(ValueError, match="does not hold"):
        spmv_probe.patched(broken, variant)
    with pytest.raises(SystemExit):
        spmv_probe.main(["--variants", "gather_only,bogus"])


@pytest.mark.parametrize("k", [1, 8, 51])
def test_spmv_probe_gather_helpers(k):
    """tune/spmv_probe.py's gather floor: the stored entries' ids, the
    32-byte sectors their rows of x span and the hashed rows equal brute
    force and the kernel source's own hash."""
    rng = np.random.default_rng(k)
    rows, width, n = 9, 6, 40
    cols = rng.integers(0, n, (rows + 3, width)).astype(np.int32)
    counts = rng.integers(0, width + 1, rows).astype(np.int32)
    got = spmv_probe._stored_ids(torch.zeros((rows + 3, width)),
                                 torch.from_numpy(cols),
                                 torch.from_numpy(counts))
    want = [cols[r, w] for r in range(rows) for w in range(counts[r])]
    assert got.dtype == torch.int32 and got.tolist() == want
    sectors = sum(len({b // 32 for b in range(c * 4 * k, (c + 1) * 4 * k)})
                  for c in want)
    assert spmv_probe._sectors(got, k) == sectors

    def mix(v):
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)

    assert "0x7feb352du" in spmv_probe.GATHER_SOURCE
    assert "0x846ca68bu" in spmv_probe.GATHER_SOURCE
    hashed = spmv_probe._hashed_rows(20000, n * k, "cpu")
    assert [int(hashed[e]) for e in (0, 1, 2, 99, 12345, 19999)] == [
        mix(e) % (n * k) for e in (0, 1, 2, 99, 12345, 19999)]
