"""repro_torch block Gauss-Seidel on CSR (``gs_block > 1``) against the
reference: ``CsrOp.row_panel`` and ``residual_panel``, the block sweep's
plain version and ``solve(format="csr", gs_block=B)`` against the
reference's scan engine (``_sequential_scan_impl``) on the reference's own
direction stream (``draw_picks(..., block=B)``, handed to the port as
``picks=``), and the port's own contracts: the block sweep at block 1 is
the coordinate sweep, a column does not depend on the columns riding
along, chained serving chunks are the one-shot solve, and the formats and
actions without block GS refuse it.  The launcher's host side (the path,
the scratch of the global path) is checked with its C entry stood in.

Tolerances: ``row_panel`` bitwise (the same values scattered into zeros);
``residual_panel`` 1e-5 relative (the reference's einsum and the port's
slot-by-slot contraction add one row's products in different orders);
solves and sweeps: the iterate and the err_sq / resid records within
1e-5 relative, in norm and per record (``_close``, the measure of
tests/test_torch_block_gs.py): the reference multiplies a densified
panel, whose sum over a row runs in another order.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import spd as ref_spd  # noqa: E402
from repro.core.engine import _sequential_scan_impl  # noqa: E402
from repro.core.engine import draw_picks as ref_draw_picks  # noqa: E402
from repro.core.operators import as_operator as ref_as_operator  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import Schedule, solve  # noqa: E402
from repro_torch.core.operators import as_operator  # noqa: E402
from repro_torch.kernels import _build, ops, ref, sweep_csr  # noqa: E402

N = 256
PROBLEMS = {"sparse": lambda k: ref_spd.random_sparse_spd(
                N, row_nnz=8, n_rhs=k, seed=3),
            "laplacian": lambda k: ref_spd.laplacian_spd(16, n_rhs=k, seed=4)}
BLOCKS = [1, 4, 8, 32, 24]          # 24 leaves 16 rows in no panel
STORAGE = [None, "bfloat16"]


def _pair(kind, k, storage):
    """(reference problem, reference CSR op, port problem, port CSR op)."""
    r = PROBLEMS[kind](k)
    p = convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                       r.lam_max, "cpu")
    return (r, ref_as_operator(r.A, "csr", rows_per_panel=8,
                               storage_dtype=storage),
            p, as_operator(p.A, "csr", rows_per_panel=8,
                           storage_dtype=storage))


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


def _close(got, want):
    """The iterate and the records within 1e-5 relative, in norm, and each
    record of each column on its own (tests/test_torch_block_gs.py's
    measure: sqrt(err_sq) and resid within 1e-5 of themselves plus 1e-6 of
    the first record)."""
    for field in ("x", "err_sq", "resid"):
        w = torch.from_numpy(_np(getattr(want, field)))
        assert _rel(getattr(got, field), w) <= 1e-5, field
    for field, f in (("err_sq", torch.sqrt), ("resid", lambda r: r)):
        w = f(torch.from_numpy(_np(getattr(want, field))).double())
        g = f(getattr(got, field).double())
        assert g.shape == w.shape, field
        bad = ((g - w).abs() > 1e-5 * w + 1e-6 * w[0]).nonzero().tolist()
        assert not bad, (field, bad)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("kind", sorted(PROBLEMS))
def test_row_panel_is_the_references_bitwise(kind, block, storage):
    _, rop, _, op = _pair(kind, 1, storage)
    for bi in sorted({0, N // block // 2, N // block - 1}):
        got = op.row_panel(bi, block)
        want = rop.row_panel(bi, block)
        assert got.dtype == op.data.dtype and got.shape == (block, N)
        np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("kind", sorted(PROBLEMS))
def test_residual_panel_matches_reference(kind, block, storage):
    r, rop, p, op = _pair(kind, 3, storage)
    x = np.random.default_rng(block).standard_normal((N, 3)).astype(
        np.float32)
    for bi in sorted({0, N // block - 1}):
        got = op.residual_panel(p.b, torch.from_numpy(x), bi, block)
        want = torch.from_numpy(_np(rop.residual_panel(r.b, jnp.asarray(x),
                                                       bi, block)))
        assert got.dtype == torch.float32 and got.shape == (block, 3)
        assert _rel(got, want) <= 1e-5


def _ref_solve(r, rop, block, sweeps, key):
    nd = N // block
    picks = ref_draw_picks(rop, "gs", key, sweeps * nd, block=block)
    want = _sequential_scan_impl(
        rop, r.b, jnp.zeros_like(r.b), r.x_star, action="gs", key=key,
        num_iters=sweeps * nd, beta=0.9, block=block, record_every=nd,
        picks=picks)
    return want, torch.from_numpy(np.array(picks))


@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("kind", sorted(PROBLEMS))
def test_solve_matches_reference_scan(kind, block, storage):
    r, rop, p, _ = _pair(kind, 3, storage)
    nd = N // block
    want, picks = _ref_solve(r, rop, block, 3, jax.random.key(block))
    got = solve(p, format="csr", gs_block=block, picks=picks, beta=0.9,
                rows_per_panel=8, storage_dtype=storage,
                schedule=Schedule(num_iters=3 * nd, record_every=nd))
    _close(got, want)
    assert float(got.resid[-1].max()) < float(got.resid[0].max())


# Rows wider than 64 slots: the sweep's window tail.
WIDE = lambda k: ref_spd.random_sparse_spd(N, row_nnz=32, n_rhs=k,  # noqa: E731
                                           seed=5)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16"])
@pytest.mark.parametrize("block", [8, 24, 40])   # 24, 40: n % block != 0
@pytest.mark.parametrize("kind", ["sparse", "wide"])
def test_plain_block_sweep_matches_reference(kind, block, storage, k,
                                             monkeypatch):
    """The plain block sweep over a whole stream, from x = 0, against the
    reference's scan engine on the same stream (one record); "wide" has
    rows of more than 64 slots."""
    monkeypatch.setitem(PROBLEMS, "wide", WIDE)
    r, rop, p, op = _pair(kind, k, storage)
    assert (op.padded_rows()[0].shape[1] > 64) == (kind == "wide")
    nd = N // block
    key = jax.random.key(11)
    picks = ref_draw_picks(rop, "gs", key, 2 * nd, block=block)
    want = _sequential_scan_impl(
        rop, r.b, jnp.zeros_like(r.b), r.x_star, action="gs", key=key,
        num_iters=2 * nd, beta=0.9, block=block, picks=picks)
    vals, cols = op.padded_rows()
    got = ops.sweep_rows_block_gs(vals, cols, p.b, torch.zeros_like(p.b),
                                  torch.from_numpy(np.array(picks)),
                                  block=block, beta=0.9)
    assert _rel(got, torch.from_numpy(_np(want.x))) <= 1e-5


@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16"])
def test_block_sweep_at_block_1_is_the_gs_sweep_bitwise(storage):
    _, _, p, op = _pair("sparse", 3, storage)
    vals, cols = op.padded_rows()
    g = torch.Generator().manual_seed(5)
    x = torch.randn((N, 3), generator=g)
    picks = torch.randint(0, N, (300,), generator=g)
    block = ops.sweep_rows_block_gs(vals, cols, p.b, x, picks, block=1,
                                    beta=0.8)
    coord = ref.sweep_rows_gs_ref(vals, cols, p.b, x, picks, beta=0.8)
    np.testing.assert_array_equal(block.numpy(), coord.numpy())
    assert not torch.equal(block, x)


@pytest.mark.parametrize("storage", STORAGE, ids=["f32", "bf16"])
@pytest.mark.parametrize("block", [4, 24])
def test_column_0_is_independent_of_k_bitwise(block, storage):
    """Column 0 of a k = 3 block sweep and solve equals the k = 1 run
    bitwise."""
    _, _, p3, op = _pair("laplacian", 3, storage)
    vals, cols = op.padded_rows()
    g = torch.Generator().manual_seed(block)
    x = torch.randn((N, 3), generator=g)
    picks = torch.randint(0, N // block, (40,), generator=g)
    three = ops.sweep_rows_block_gs(vals, cols, p3.b, x, picks, block=block)
    one = ops.sweep_rows_block_gs(vals, cols, p3.b[:, :1].contiguous(),
                                  x[:, :1].contiguous(), picks, block=block)
    np.testing.assert_array_equal(one[:, 0].numpy(), three[:, 0].numpy())
    p1 = p3._replace(b=p3.b[:, :1].contiguous(),
                     x_star=p3.x_star[:, :1].contiguous())
    kw = dict(format="csr", gs_block=block, picks=picks,
              storage_dtype=storage, schedule=Schedule(num_iters=40,
                                                       record_every=10))
    a, b = solve(p3, **kw), solve(p1, **kw)
    for f in ("x", "err_sq", "resid"):
        np.testing.assert_array_equal(getattr(b, f)[:, 0].numpy(),
                                      getattr(a, f)[:, 0].numpy())


def test_chained_chunks_equal_solve_sequential_bitwise():
    """Chunks of ``sequential_chunk`` over consecutive slices of one
    stream give bitwise the one-shot solve's iterate and last residual;
    ``solve_batched`` too."""
    _, _, p, op = _pair("sparse", 3, None)
    block, rec, chunks = 8, 16, 4
    picks = torch.randint(0, N // block, (rec * chunks,),
                          generator=torch.Generator().manual_seed(2))
    once = engine.solve_sequential(op, p.b, torch.zeros_like(p.b), p.x_star,
                                   action="gs", num_iters=rec * chunks,
                                   picks=picks, block=block, record_every=rec)
    x = torch.zeros_like(p.b)
    for c in range(chunks):
        x, resid = engine.sequential_chunk(
            op, p.b, x, picks[c * rec:(c + 1) * rec].to(torch.int32),
            action="gs", block=block)
    np.testing.assert_array_equal(x.numpy(), once.x.numpy())
    np.testing.assert_array_equal(resid.numpy(), once.resid[-1].numpy())
    bat = engine.solve_batched(op, p.b, action="gs", num_iters=rec * chunks,
                               tol=0.0, picks=picks, block=block,
                               record_every=rec)
    np.testing.assert_array_equal(bat.x.numpy(), once.x.numpy())
    assert bat.iters_run == rec * chunks


def test_each_record_chunk_is_one_block_sweep_call(monkeypatch):
    real = ops.sweep_rows_block_gs
    seen = []

    def spy(*args, **kw):
        seen.append((args[-1].clone(), kw["block"]))
        return real(*args, **kw)
    monkeypatch.setattr(ops, "sweep_rows_block_gs", spy)
    _, _, p, _ = _pair("sparse", 2, None)
    picks = torch.randint(0, N // 8, (96,),
                          generator=torch.Generator().manual_seed(1))
    solve(p, format="csr", gs_block=8, picks=picks,
          schedule=Schedule(num_iters=96, record_every=32))
    assert [b for _, b in seen] == [8, 8, 8]
    assert torch.equal(torch.cat([s for s, _ in seen]), picks)


def test_block_gs_refusals():
    _, _, p, _ = _pair("sparse", 1, None)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="aligned row panels"):
        solve(p, format="ell", gs_block=8, generator=g,
              schedule=Schedule(num_iters=8))
    with pytest.raises(NotImplementedError, match="aligned row panels"):
        solve(p, format="banded", block=32, bands=1, gs_block=8, generator=g,
              schedule=Schedule(num_iters=8))
    with pytest.raises(ValueError, match="Gauss-Seidel granularity"):
        solve(p, format="csr", gs_block=8, action="rk", generator=g,
              schedule=Schedule(num_iters=8))
    with pytest.raises(ValueError, match="bounded-delay"):
        solve(p, format="csr", gs_block=8, generator=g,
              delay_generator=torch.Generator().manual_seed(1),
              schedule=Schedule(num_iters=8, tau=2))


def test_out_of_range_blocks_raise():
    _, _, p, op = _pair("sparse", 1, None)
    vals, cols = op.padded_rows()
    x = torch.zeros_like(p.b)
    with pytest.raises(IndexError, match="pick ids"):
        ops.sweep_rows_block_gs(vals, cols, p.b, x, torch.tensor([0, 32]),
                                block=8)
    with pytest.raises(IndexError, match="pick ids"):
        ops.sweep_rows_block_gs(vals, cols, p.b, x, torch.tensor([-1]),
                                block=8)
    with pytest.raises(IndexError, match="pick ids"):
        solve(p, format="csr", gs_block=24, picks=torch.tensor([10] * 4),
              schedule=Schedule(num_iters=4))
    with pytest.raises(ValueError, match="block 257"):
        ops.sweep_rows_block_gs(vals, cols, p.b, x, torch.tensor([0]),
                                block=257)
    with pytest.raises(ValueError, match="not"):
        ops.sweep_rows_block_gs(vals[:100].contiguous(),
                                cols[:100].contiguous(), p.b, x,
                                torch.tensor([0]), block=8)
    with pytest.raises(IndexError, match="outside"):
        op.row_panel(32, 8)
    with pytest.raises(IndexError, match="outside"):
        op.residual_panel(p.b, x, 10, 24)


# The launcher on the CPU, its C entry stood in (as in
# tests/test_torch_sweep_dispatch.py): the path, the scratch and the
# arguments it hands the kernel.
CAP = 232448          # the opt-in shared memory of an H100 CTA, bytes


@pytest.fixture
def fake_entry(monkeypatch):
    calls = []

    def c_entry(source, kernel, vals_dtype, cols_dtype, argtypes):
        assert (source, kernel) == ("sweep_csr", "sweep_rows_block_gs")
        assert argtypes is sweep_csr._BLOCK_GS_ARGS
        return lambda *args: calls.append(args) or 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "c_entry", c_entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        _Stream())
    monkeypatch.setattr(sweep_csr, "shared_capacity", lambda device: CAP)
    monkeypatch.setattr(sweep_csr, "LAUNCHES", dict(sweep_csr.LAUNCHES))
    return calls


def _edge_n(width, block, vbytes, ibytes):
    """The largest n whose x and a ring of min(block, a pass, 32) rows a
    stage fit CAP (the shared-memory path's size rule)."""
    plan = sweep_csr.block_plan(1, width, block, vbytes, ibytes, CAP)
    rows = min(block, plan.warps * 32 // plan.lanes, sweep_csr.MIN_TILE_ROWS)
    ring = sweep_csr.ring_bytes(0, width, rows, vbytes, ibytes, False)
    return (CAP - ring) // 16 * 16 // 4


@pytest.mark.parametrize("vbytes, ibytes", [(4, 4), (2, 2)],
                         ids=["f32_i32", "bf16_i16"])
@pytest.mark.parametrize("block", [8, 128, 1000])
def test_block_plan_at_the_capacity_edge(block, vbytes, ibytes):
    """x plus the ring: the shared-memory path up to the edge and not past
    it; a ring plan's barriers, x and stages fit CAP, and its tile is the
    most rows whose ring fits (up to the block and a pass).  Past the edge
    a pick of more than GLOBAL_RING_BLOCK rows runs the first design, x in
    shared memory when x and the gammas fit."""
    width = 51
    edge = _edge_n(width, block, vbytes, ibytes)
    for n, shared in ((16384, True), (edge, True), (edge + 4, False)):
        plan = sweep_csr.block_plan(n, width, block, vbytes, ibytes, CAP)
        if not shared and block > sweep_csr.GLOBAL_RING_BLOCK:
            first = sweep_csr.fits_shared(n + block, CAP)
            assert plan == sweep_csr.BlockPlan(first, 32, 8, 0), plan
            continue
        assert plan.shared is shared, (n, plan)
        pass_rows = plan.warps * 32 // plan.lanes
        assert 0 < plan.tile_rows <= min(block, pass_rows)
        size = functools.partial(sweep_csr.ring_bytes, n, width,
                                 vbytes=vbytes, ibytes=ibytes, shared=shared)
        assert size(plan.tile_rows) <= CAP
        assert plan.tile_rows == min(block, pass_rows) or \
            size(plan.tile_rows + 1) > CAP
    # eight warps (a warp a row at block 8), lanes a row as the rows ask
    plan = sweep_csr.block_plan(16384, width, block, vbytes, ibytes, CAP)
    assert (plan.warps, plan.lanes) == {8: (8, 32), 128: (8, 2),
                                        1000: (8, 1)}[block]
    # the global path keeps the ring up to GLOBAL_RING_BLOCK rows a pick
    plan = sweep_csr.block_plan(16384, width, block, vbytes, ibytes, CAP,
                                shared=False)
    assert not plan.shared
    assert (plan.tile_rows > 0) == (block <= sweep_csr.GLOBAL_RING_BLOCK)


@pytest.mark.parametrize("vbytes, ibytes", [(4, 4), (2, 2)],
                         ids=["f32_i32", "bf16_i16"])
@pytest.mark.parametrize("n, want", [
    (CAP // 4 - 128, sweep_csr.BlockPlan(True, 32, 8, 0)),   # x and the
    (CAP // 4 - 127, sweep_csr.BlockPlan(False, 32, 8, 0)),  # gammas just fit
])
def test_block_plan_first_design_at_the_capacity_edge(n, want, vbytes,
                                                      ibytes):
    """Where no ring fits beside x, a pick of 128 rows runs the first
    design, whose shared-memory path holds x and the block's gammas: up to
    n + 128 = CAP // 4 and not past it."""
    assert sweep_csr.block_plan(n, 51, 128, vbytes, ibytes, CAP) == want


def test_block_plan_without_a_ring():
    """Rows too wide for two one-row stages run the first design (tile 0),
    x in shared memory when x and the gammas fit."""
    width = CAP // 8
    assert sweep_csr.block_plan(4096, width, 128, 4, 4, CAP) == \
        sweep_csr.BlockPlan(True, 32, 8, 0)
    assert sweep_csr.block_plan(CAP // 4, width, 128, 4, 4, CAP).shared \
        is False
    assert sweep_csr.block_plan(4096, width, 128, 4, 4, CAP,
                                shared=False).shared is False


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.int32),
                                    (torch.bfloat16, torch.int16)],
                         ids=["f32_i32", "bf16_i16"])
@pytest.mark.parametrize("n, block, width, override, want_shared, staged", [
    (16384, 128, 51, None, 1, False),      # the main path
    (16384, 8, 51, None, 1, False),
    (16384, 1000, 51, None, 1, True),      # a pick in several tiles
    (16384, 128, 51, False, 0, True),      # global: the first design
    (16384, 8, 51, False, 0, False),       # global: the ring
    (CAP // 4 - 128, 128, 51, None, 1, False),  # x and the gammas just fit
    (CAP // 4 - 127, 128, 51, None, 0, True),
    (CAP // 4, 8, 51, True, 1, False),     # x alone fills CAP: told to
    (256, 128, CAP // 8, None, 1, False),  # no ring: the first design
    (256, 128, CAP // 8, False, 0, True),
])
def test_block_launcher_passes_the_path(fake_entry, dtypes, n, block, width,
                                        override, want_shared, staged):
    k = 3
    vals = torch.ones((n, width), dtype=dtypes[0])
    cols = torch.zeros((n, width), dtype=dtypes[1])
    x = torch.zeros((n, k))
    blocks = torch.zeros((7,), dtype=torch.int32)
    kw = {} if override is None else {"_shared": override}
    out = sweep_csr.sweep_rows_block_gs(vals, cols, x, x, blocks, block=block,
                                        beta=0.5, limit=n // block, **kw)
    assert out.shape == x.shape and out.data_ptr() != x.data_ptr()
    (args,) = fake_entry
    assert len(args) == len(sweep_csr._BLOCK_GS_ARGS)
    assert (args[4] is not None) == staged   # the gammas' scratch
    plan = sweep_csr.block_plan(n, width, block, vals.element_size(),
                                cols.element_size(), CAP, shared=override)
    assert plan.shared == bool(want_shared)
    assert args[6:17] == (width, n, k, 7, n // block, block, 0.5, want_shared,
                          *plan[1:])
    assert sweep_csr.LAUNCHES["sweep_rows_block_gs"] == 1


def test_block_launcher_aligns_the_windows(fake_entry):
    """The ring's bulk copies need 16-byte-aligned windows: a view that
    starts elsewhere is copied first; an aligned one is passed as it is."""
    n, width, k = 64, 5, 2
    vals = torch.ones((n + 1, width))[1:]
    cols = torch.zeros((n + 1, width), dtype=torch.int32)[1:]
    assert vals.data_ptr() % 16 and cols.data_ptr() % 16
    x = torch.zeros((n, k))
    blocks = torch.zeros((3,), dtype=torch.int32)
    sweep_csr.sweep_rows_block_gs(vals, cols, x, x, blocks, block=8, beta=1.0,
                                  limit=n // 8)
    aligned = torch.ones((n, width))
    sweep_csr.sweep_rows_block_gs(aligned, cols.clone(), x, x, blocks,
                                  block=8, beta=1.0, limit=n // 8)
    first, second = fake_entry
    assert first[0] % 16 == 0 and first[1] % 16 == 0
    assert first[0] != vals.data_ptr()
    assert second[0] == aligned.data_ptr()


@pytest.mark.parametrize("k, steps", [(0, 4), (3, 0)])
def test_block_launcher_without_work_launches_nothing(fake_entry, k, steps):
    vals = torch.ones((16, 2))
    cols = torch.zeros((16, 2), dtype=torch.int32)
    x = torch.zeros((16, k))
    out = sweep_csr.sweep_rows_block_gs(
        vals, cols, x, x, torch.zeros((steps,), dtype=torch.int32), block=4,
        beta=1.0, limit=4)
    assert out.shape == x.shape and not fake_entry
    assert sweep_csr.LAUNCHES["sweep_rows_block_gs"] == 0
