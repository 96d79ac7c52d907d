"""The segment-sum matvecs of repro_torch (``spmv_csr`` and its predicated
twin) read each row's slots from the CSR layout (``row_start``,
``row_nnz``) and add panel 0's tail to row 0 once (``panel0_tail``), where
the reference's kernels sum over ``row_id``.  These tests hold what that
rests on: the layout invariant on ragged port operators, the port's layout
arrays and flag against the reference operator's, the exactness of the
layout chain against the row-id chain for x holding NaN, inf and -0, the
wrappers' checks of the layout arguments, ``CsrOp.matvec_segsum`` passing
them, and ``convert.csr_from_arrays`` refusing a layout that is not the
packed one.

Tolerances: none; every comparison is exact (integer layouts, or chains
compared bitwise).  The CUDA kernel itself runs only on the card
(chip_smoke.py, tune/spmv_probe.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CsrOp as RefCsrOp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import operators  # noqa: E402
from repro_torch.core.operators import CsrOp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

M, N, MOST = 53, 80, 70          # 53 rows: the last panel of 8 is ragged

LAYOUTS = [(kind, R, storage) for kind in ("ragged", "empty0", "exact0")
           for R in (1, 8) for storage in (None, "bfloat16")]


def _dense(kind, R, seed=0):
    """(M, N) f32 with rows of 0 to MOST nonzeros at distinct columns, a
    zeroed panel of 8 rows (rows 16-23) and every 7th row from row 3 empty;
    ``empty0`` zeroes panel 0 too, ``exact0`` gives panel 0's rows MOST
    nonzeros each (built with lane 1, panel 0 fills its width exactly)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((M, N), np.float32)
    for r in range(M):
        cnt = rng.integers(0, MOST + 1)
        A[r, rng.choice(N, cnt, replace=False)] = rng.standard_normal(cnt)
    A[16:24] = 0.0
    A[3::7] = 0.0
    if kind == "empty0":
        A[:R] = 0.0
    if kind == "exact0":
        for r in range(R):
            A[r, rng.choice(N, MOST, replace=False)] = rng.uniform(0.5, 1.5,
                                                                   MOST)
    return A


def _ops(kind, R, storage):
    """The port's and the reference's CsrOp of one layout."""
    A = _dense(kind, R)
    lane = 1 if kind == "exact0" else 128
    port = CsrOp.from_dense(torch.from_numpy(A), rows_per_panel=R,
                            storage_dtype=storage, lane=lane)
    ref = RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=R,
                              storage_dtype=storage, lane=lane)
    return port, ref


@pytest.mark.parametrize("kind,R,storage", LAYOUTS)
def test_rows_slots_are_their_layout_ranges(kind, R, storage):
    """Inside row r's panel the slots whose row_id is r are exactly
    [row_start[r], row_start[r] + row_nnz[r]) for r != 0, and for r = 0
    that range followed by panel 0's tail [panel_nnz[0], W); the memoised
    panel0_tail says whether that tail holds a slot."""
    op, _ = _ops(kind, R, storage)
    W = op.panel_width
    row_id = op.row_id.numpy()
    starts, counts = op.row_start.numpy(), op.row_nnz.numpy()
    for r in range(M):
        p = r // R
        got = np.flatnonzero(row_id[p * W:(p + 1) * W] == r) + p * W
        want = list(range(starts[r], starts[r] + counts[r]))
        if r == 0:
            want += list(range(int(op.panel_nnz()[0]), W))
        assert got.tolist() == want, r
    rows = op.segsum_rows()
    assert rows["row_start"] is op.row_start and rows["row_nnz"] is op.row_nnz
    assert rows["panel0_tail"] == (int(op.panel_nnz()[0]) < W)
    assert rows["panel0_tail"] == (kind != "exact0")
    assert op.segsum_rows()["panel0_tail"] is rows["panel0_tail"]
    if kind == "empty0":
        assert int(op.panel_nnz()[0]) == 0
    assert bool((op.panel_nnz() == 0).any())


@pytest.mark.parametrize("kind,R,storage", LAYOUTS)
def test_layout_and_tail_flag_equal_the_reference(kind, R, storage):
    """The port's row_start/row_nnz are the reference operator's, and
    panel0_tail is the flag the reference's own arrays give (panel 0's
    stored count, from row_nnz, below panel_width)."""
    op, ref = _ops(kind, R, storage)
    assert op.panel_width == ref.panel_width
    assert np.array_equal(op.row_start.numpy(), np.asarray(ref.row_start))
    assert np.array_equal(op.row_nnz.numpy(), np.asarray(ref.row_nnz))
    assert np.array_equal(op.row_id.numpy(), np.asarray(ref.row_id))
    panel0 = int(np.asarray(ref.row_nnz)[:R].sum())
    assert op.segsum_rows()["panel0_tail"] == (panel0 < ref.panel_width)


def _chain(terms, k):
    acc = torch.zeros(k)
    for v, xr in terms:
        acc = acc + v * xr
    return acc


@pytest.mark.parametrize("kind,R,storage", LAYOUTS)
def test_layout_chain_is_bitwise_the_row_id_chain(kind, R, storage):
    """Each output as the kernel forms it (row r's own slots in slot
    order, then for row 0 one term of +0 times x[0] where panel0_tail) has
    the bits of the row-id segment sum over r's panel in slot order, for
    x holding NaN, inf and -0 in rows 0 and 1 and elsewhere."""
    op, _ = _ops(kind, R, storage)
    k, W = 6, op.panel_width
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, k)).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -0.0, 0.0]
    x[1, :3] = [-0.0, np.nan, -np.inf]
    x[5, 2], x[9] = np.inf, -0.0
    xt = torch.from_numpy(x)
    data, idx = op.data.float(), op.indices.long()
    rows = op.segsum_rows()
    for r in range(M):
        p = r // R
        panel = range(p * W, (p + 1) * W)
        want = _chain([(data[s], xt[idx[s]]) for s in panel
                       if int(op.row_id[s]) == r], k)
        s0, cnt = int(rows["row_start"][r]), int(rows["row_nnz"][r])
        terms = [(data[s], xt[idx[s]]) for s in range(s0, s0 + cnt)]
        if r == 0 and rows["panel0_tail"]:
            terms.append((torch.tensor(0.0), xt[0]))
        got = _chain(terms, k)
        assert got.numpy().tobytes() == want.numpy().tobytes(), r


BAD_ROWS = {
    "int64": lambda t: t.long(),
    "short": lambda t: t[:-1],
    "2-D": lambda t: t[:, None],
    "strided": lambda t: torch.stack([t, t], 1)[:, 0],
}


def _segsum_calls(op, x):
    kw = dict(m=op.shape[0], rows_per_panel=op.rows_per_panel,
              panel_width=op.panel_width)
    flat = (op.data, op.indices, op.row_id)
    return {
        "spmv_csr": lambda **rows: ops.spmv_csr(*flat, x, **kw, **rows),
        "spmv_csr_prefetch": lambda **rows: ops.spmv_csr_prefetch(
            *flat, op.panel_nnz(), x, **kw, **rows)}


@pytest.mark.parametrize("bad", sorted(BAD_ROWS))
@pytest.mark.parametrize("arg", ["row_start", "row_nnz"])
@pytest.mark.parametrize("kernel", ["spmv_csr", "spmv_csr_prefetch"])
def test_wrappers_reject_a_wrong_row_layout(kernel, arg, bad):
    """row_start and row_nnz must be contiguous int32 of shape (m,) on x's
    device."""
    op, _ = _ops("ragged", 8, None)
    x = torch.ones((N, 3))
    call = _segsum_calls(op, x)[kernel]
    rows = op.segsum_rows()
    call(**rows)
    with pytest.raises(ValueError, match=f"{arg} must be"):
        call(**{**rows, arg: BAD_ROWS[bad](rows[arg])})


@pytest.mark.parametrize("kernel", ["spmv_csr", "spmv_csr_prefetch"])
def test_wrappers_take_a_bool_tail_flag(kernel):
    """panel0_tail is a bool."""
    op, _ = _ops("ragged", 1, None)
    call = _segsum_calls(op, torch.ones((N, 2)))[kernel]
    with pytest.raises(TypeError, match="panel0_tail must be a bool"):
        call(**{**op.segsum_rows(), "panel0_tail": 1})


@pytest.mark.parametrize("skip_empty", [False, True])
def test_matvec_segsum_passes_the_row_layout(monkeypatch, skip_empty):
    """CsrOp.matvec_segsum hands its wrapper the operator's
    segsum_rows()."""
    op, _ = _ops("empty0", 8, None)
    name = "spmv_csr_prefetch" if skip_empty else "spmv_csr"
    seen = []
    real = getattr(operators.ops, name)

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(operators.ops, name, spy)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (N, 4)).astype(np.float32))
    y = op.matvec_segsum(x, skip_empty=skip_empty)
    assert len(seen) == 1
    rows = op.segsum_rows()
    assert seen[0]["row_start"] is rows["row_start"]
    assert seen[0]["row_nnz"] is rows["row_nnz"]
    assert seen[0]["panel0_tail"] is True
    torch.testing.assert_close(y, op.to_dense() @ x, rtol=1e-5, atol=1e-5)


BREAK = {
    "row id": lambda a: a["row_id"].__setitem__(int(a["row_start"][1]), 0),
    "row start": lambda a: a["row_start"].__setitem__(1, a["row_start"][1]
                                                      + 1),
    "padding value": lambda a: a["data"].__setitem__(-1, 1.0),
    "padding sign": lambda a: a["data"].__setitem__(-1, -0.0),
    "padding column": lambda a: a["indices"].__setitem__(-1, 1),
}


@pytest.mark.parametrize("what", ["as built", *sorted(BREAK)])
def test_csr_from_arrays_takes_only_the_packed_layout(what):
    """convert.csr_from_arrays takes the reference's layout as it is and
    refuses one whose rows do not start where the packing puts them, whose
    row ids disagree with the row windows, or whose padding is not +0 at
    column 0."""
    _, ref = _ops("ragged", 8, None)
    arrays = {name: np.array(getattr(ref, name)) for name in
              ("data", "indices", "row_id", "row_start", "row_nnz")}
    assert int(arrays["row_nnz"][0]) > 0 and int(arrays["row_nnz"][1]) > 0
    layout = dict(shape=ref.shape, nnz=ref.nnz, row_cap=ref.row_cap,
                  rows_per_panel=ref.rows_per_panel,
                  panel_width=ref.panel_width)
    if what == "as built":
        op = convert.csr_from_arrays(**arrays, **layout, device="cpu")
        assert np.array_equal(op.row_id.numpy(), arrays["row_id"])
        return
    BREAK[what](arrays)
    with pytest.raises(ValueError, match="packed panel layout"):
        convert.csr_from_arrays(**arrays, **layout, device="cpu")
