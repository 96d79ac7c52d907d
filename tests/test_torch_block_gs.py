"""repro_torch dense block Gauss-Seidel against the reference: the kernel's
plain version against the Pallas kernel (interpret mode), the dense
block-GS solve and ``block_gs_solve`` on the reference's own direction
stream, ``dense_spd``, and the port's own contracts; the CUDA kernel's
launch plan and scratch size (``kernels/block_gs.py``) against brute
force, the argument parsing of ``tune/block_gs_probe.py`` and the
source patches of ``tune/block_gs_segments.py``.

Tolerances: the plain version against the Pallas kernel at the reference's
own (tests/test_kernels.py: 1e-5 for f32, 5e-2 for bf16 storage, whose
coefficients the two widen at different points); solves: the iterate
and the err_sq / resid records within 1e-5 relative, in norm, and each
record on its own (see ``_close``; different f32 summation orders of the
same panel products); dense against banded block GS 1e-5 (the same
function, different summation orders); ``dense_spd``'s matrix bitwise.
"""
import re
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import block_gs_solve as ref_block_gs_solve  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro.core.engine import draw_picks as ref_draw_picks  # noqa: E402
from repro.core.engine import solve_sequential as ref_solve_seq  # noqa: E402
from repro.core.operators import DenseOp as RefDenseOp  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rgs, spd  # noqa: E402
from repro_torch.core.engine import Schedule, solve  # noqa: E402
from repro_torch.core.operators import DenseOp  # noqa: E402
from repro_torch.kernels import block_gs, ops, ref  # noqa: E402
from repro_torch.launch.mesh import process_group  # noqa: E402
from repro_torch.tune import block_gs_probe, block_gs_segments  # noqa: E402


def _port(r):
    return convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                          r.lam_max, "cpu")


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("n,block,k", [(256, 128, 8), (512, 128, 64),
                                       (512, 256, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_gs_plain_matches_pallas(n, block, k, dtype):
    r = ref_spd.block_banded_spd(n, block=block, bands=1, n_rhs=k, seed=0)
    A = r.A.astype(getattr(jnp, dtype))
    blocks = np.random.default_rng(1).integers(0, n // block, 12)
    x0 = np.zeros((n, k), np.float32)
    want = ref_ops.block_gs_sweep(A, r.b, jnp.asarray(x0),
                                  jnp.asarray(blocks, jnp.int32),
                                  block=block, beta=0.9, interpret=True)
    got = ops.block_gs_sweep(convert._tensor(A, "cpu"),
                             convert._tensor(r.b, "cpu"),
                             torch.from_numpy(x0), torch.from_numpy(blocks),
                             block=block, beta=0.9)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _ref_block_solve(r, key, num_iters, block, record_every):
    op = RefDenseOp(r.A)
    x0 = jnp.zeros_like(r.b)
    res = ref_solve_seq(op, r.b, x0, r.x_star, action="gs", key=key,
                        num_iters=num_iters, block=block,
                        record_every=record_every)
    picks = ref_draw_picks(op, "gs", key, num_iters, block=block)
    return res, torch.from_numpy(np.array(picks))


def _close(got, want):
    """The iterate and the records within 1e-5 relative, in norm, and each
    record of each column on its own.

    The records fall by orders of magnitude, so the norm over all of them
    is set by the first; the per-record check holds the later ones too.
    It compares the residual norm and the A-norm of the error,
    sqrt(err_sq), each within 1e-5 of itself plus 1e-6 of the first
    record: the error x - x* shrinks while the rounding of an f32 iterate
    stays near 2^-24 of |x*| (x0 = 0), and 1e-6 is 16 times that."""
    for field in ("x", "err_sq", "resid"):
        w = torch.from_numpy(np.array(getattr(want, field)))
        assert _rel(getattr(got, field), w) <= 1e-5, field
    for field, f in (("err_sq", torch.sqrt), ("resid", lambda r: r)):
        w = f(torch.from_numpy(np.array(getattr(want, field))).double())
        g = f(getattr(got, field).double())
        assert g.shape == w.shape, field
        bad = ((g - w).abs() > 1e-5 * w + 1e-6 * w[0]).nonzero().tolist()
        assert not bad, (field, bad)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


@pytest.mark.parametrize("kind,n,block", [("banded", 512, 128),
                                          ("dense", 192, 64)])
def test_dense_block_gs_solve_matches_reference(kind, n, block):
    if kind == "banded":
        r = ref_spd.block_banded_spd(n, block=block, bands=2, n_rhs=3, seed=2)
    else:
        r = ref_spd.dense_spd(n, n_rhs=3, seed=2)
    nb = n // block
    want, picks = _ref_block_solve(r, jax.random.key(5), 6 * nb, block, nb)
    got = solve(_port(r), format="dense", gs_block=block, picks=picks,
                schedule=Schedule(num_iters=6 * nb, record_every=nb))
    _close(got, want)
    assert float(got.resid[-1].max()) < float(got.resid[0].max())


def test_block_gs_solve_matches_reference():
    r = ref_spd.block_banded_spd(256, block=64, bands=1, n_rhs=2, seed=4)
    key = jax.random.key(9)
    x0 = jnp.zeros_like(r.b)
    want = ref_block_gs_solve(r.A, r.b, x0, r.x_star, key=key, num_sweeps=3,
                              block=64)
    picks = ref_draw_picks(RefDenseOp(r.A), "gs", key, 3 * 4, block=64)
    p = _port(r)
    got = rgs.block_gs_solve(p.A, p.b, torch.zeros_like(p.b), p.x_star,
                             num_sweeps=3, block=64,
                             picks=torch.from_numpy(np.array(picks)))
    _close(got, want)


def test_dense_block_gs_equals_banded_gs_on_same_picks():
    p = spd.block_banded_spd(512, block=128, bands=2, n_rhs=3, seed=6,
                             device="cpu")
    picks = torch.from_numpy(np.random.default_rng(7).integers(0, 4, 16))
    sched = Schedule(num_iters=16, record_every=4)
    dense = solve(p, format="dense", gs_block=128, picks=picks,
                  schedule=sched)
    banded = solve(p, format="banded", block=128, bands=2, picks=picks,
                   schedule=sched)
    assert _rel(dense.x, banded.x) <= 1e-5
    np.testing.assert_allclose(dense.resid.numpy(), banded.resid.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_gs_column_independent_bitwise(dtype):
    """Column 0 of a k = 5 sweep equals the k = 1 sweep bitwise: a column's
    result does not depend on the columns riding along."""
    g = torch.Generator().manual_seed(3)
    n, block = 96, 32
    A = (torch.randn((n, n), generator=g) / n + torch.eye(n)).to(dtype)
    b = torch.randn((n, 5), generator=g)
    x = torch.randn((n, 5), generator=g)
    blocks = torch.randint(0, n // block, (9,), generator=g)
    five = ops.block_gs_sweep(A, b, x, blocks, block=block, beta=0.8)
    one = ops.block_gs_sweep(A, b[:, :1].contiguous(), x[:, :1].contiguous(),
                             blocks, block=block, beta=0.8)
    np.testing.assert_array_equal(one[:, 0].numpy(), five[:, 0].numpy())
    assert not torch.equal(five, x)


@pytest.mark.parametrize("k", [1, 5, 64, 65, 130])
def test_dense_matvec_column_groups(k):
    """DenseOp.matvec multiplies in column groups of one width, so each
    column equals the solo column's product at any k (every column goes
    through one GEMM shape)."""
    g = torch.Generator().manual_seed(k)
    n = 96
    op = DenseOp(torch.randn((n, n), generator=g))
    x = torch.randn((n, k), generator=g)
    y = op.matvec(x)
    assert y.shape == (n, k) and y.is_contiguous()
    for j in {0, k // 2, k - 1}:
        np.testing.assert_array_equal(
            op.matvec(x[:, j:j + 1].contiguous())[:, 0].numpy(),
            y[:, j].numpy())


@pytest.mark.parametrize("k", [1, 64, 130])
def test_dense_matvec_is_the_product(k):
    """The grouped product is A @ x within f32 rounding (rtol/atol 1e-5:
    two summation orders of 96 products)."""
    g = torch.Generator().manual_seed(k)
    op = DenseOp(torch.randn((96, 96), generator=g))
    x = torch.randn((96, k), generator=g)
    np.testing.assert_allclose(op.matvec(x).numpy(), (op.A @ x).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_dense_padded_rhs_column_equals_solo():
    """A zero-padded RHS column leaves the real column's dense block-GS
    solve bitwise unchanged: iterate, err_sq and resid."""
    p1 = spd.block_banded_spd(256, block=64, bands=1, n_rhs=1, seed=3,
                              device="cpu")
    p2 = p1._replace(b=torch.cat([p1.b, torch.zeros_like(p1.b)], 1),
                     x_star=torch.cat([p1.x_star,
                                       torch.zeros_like(p1.x_star)], 1))
    kw = dict(format="dense", gs_block=64,
              schedule=Schedule(num_iters=4 * 4, record_every=4))
    solo = solve(p1, generator=torch.Generator().manual_seed(2), **kw)
    both = solve(p2, generator=torch.Generator().manual_seed(2), **kw)
    for f in ("x", "err_sq", "resid"):
        np.testing.assert_array_equal(getattr(both, f)[:, :1].numpy(),
                                      getattr(solo, f).numpy())


def test_block_gs_sweep_checks_its_arguments():
    A = torch.eye(8)
    b = torch.zeros((8, 2))
    with pytest.raises(IndexError, match="pick ids"):
        ops.block_gs_sweep(A, b, b, torch.tensor([0, 4]), block=2)
    with pytest.raises(ValueError, match="block 9"):
        ops.block_gs_sweep(A, b, b, torch.tensor([0]), block=9)
    with pytest.raises(TypeError, match="b must be float32"):
        ops.block_gs_sweep(A, b.double(), b, torch.tensor([0]), block=2)
    with pytest.raises(ValueError, match="is not"):
        ops.block_gs_sweep(A[:, :4].contiguous(), b, b, torch.tensor([0]),
                           block=2)
    assert torch.equal(ref.block_gs_sweep_ref(A, b, b, torch.tensor([1]),
                                              block=2), b)


def test_gs_block_outside_the_dense_gs_path_raises(tmp_path):
    p = spd.random_sparse_spd(32, row_nnz=4, n_rhs=1, seed=1, device="cpu")
    g = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="aligned row panels"):
        solve(p, format="ell", gs_block=8, generator=g,
              schedule=Schedule(num_iters=8))
    res = solve(p, format="csr", gs_block=8, generator=g,
                schedule=Schedule(num_iters=8))
    assert res.x.shape == (32, 1) and bool(torch.isfinite(res.x).all())
    with pytest.raises(ValueError, match="Gauss-Seidel granularity"):
        solve(p, format="dense", gs_block=8, action="rk", generator=g,
              schedule=Schedule(num_iters=8))
    # distributed: dense block GS runs, the sparse slab strategies refuse
    # a block as the reference's do
    with process_group("gloo", tmp_path) as group:
        res = solve(p, format="dense", gs_block=8, seed=0, group=group,
                    schedule=Schedule(rounds=1, local_steps=4))
        assert res.x.shape == (32, 1)
        with pytest.raises(NotImplementedError, match="block=8 is not "
                                                      "supported for CsrOp"):
            solve(p, format="csr", gs_block=8, seed=0, group=group,
                  schedule=Schedule(rounds=1, local_steps=4))


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 3)])
def test_dense_spd_matches_reference(n, seed):
    r = ref_spd.dense_spd(n, n_rhs=2, seed=seed)
    p = spd.dense_spd(n, n_rhs=2, seed=seed, device="cpu")
    np.testing.assert_array_equal(p.A.numpy(), np.asarray(r.A))
    np.testing.assert_allclose(float(p.lam_min), float(r.lam_min), rtol=1e-4)
    np.testing.assert_allclose(float(p.lam_max), float(r.lam_max), rtol=1e-4)
    torch.testing.assert_close(p.b, p.A @ p.x_star, rtol=0, atol=0)


# The dense block-GS kernel's launch plan (kernels/block_gs.py::plan, the
# source's make_plan, which chip_smoke.py holds equal to it on the card)
# against brute force, on an H100's 132 SMs and 232448 bytes of opt-in
# shared memory a CTA.
H100 = dict(sms=132, capacity=232448)
PLAN_SHAPES = [(16384, 128, 51, 4), (16384, 128, 51, 2), (16384, 128, 1, 4),
               (16384, 256, 51, 4), (3000, 20, 3, 4), (1536, 64, 70, 2),
               (1002, 3, 2, 4), (2048, 96, 5, 4), (4096, 256, 200, 4),
               (256, 1, 1, 2), (3002, 19, 51, 4), (3002, 2, 3, 2)]


@pytest.mark.parametrize("n,block,k,itemsize", PLAN_SHAPES)
def test_block_gs_plan_covers_every_part_once(n, block, k, itemsize):
    """CTA c owns units c, c + grid, ...; the units' (slice, row, column)
    parts cover each part of a step exactly once."""
    p = block_gs.plan(n, block, k, itemsize, **H100)
    assert p.grid >= 1 and p.stages >= 1   # else the C entry refuses it
    owned, parts = Counter(), Counter()
    for c in range(p.grid):
        mine = range(c, p.units, p.grid)
        assert 1 <= len(mine) <= p.per_cta
        for u in mine:
            owned[u] += 1
            ct, rem = divmod(u, p.slices * p.groups)
            sl, rg = divmod(rem, p.groups)
            for r in range(rg * p.rows, min(block, (rg + 1) * p.rows)):
                for col in range(ct * p.cols, min(k, (ct + 1) * p.cols)):
                    parts[sl, r, col] += 1
    assert sorted(owned) == list(range(p.units))
    assert set(owned.values()) == {1}
    assert len(parts) == -(-n // block_gs.SLICE) * block * k
    assert set(parts.values()) == {1}


@pytest.mark.parametrize("n,block,k,itemsize", PLAN_SHAPES)
def test_block_gs_plan_fits_shared_memory(n, block, k, itemsize):
    """The CTA's mbarriers, x tiles and panel stages fit, with as many
    stages as fit (up to MAX_STAGES), and the x tiles stay resident (one a
    unit) whenever they fit beside two stages."""
    cap = H100["capacity"]
    p = block_gs.plan(n, block, k, itemsize, **H100)
    stage = p.rows * p.pitch
    xtile = block_gs.SLICE * (-(-p.cols // 4) * 4) * 4
    assert p.pitch % 16 == 0 and p.pitch >= block_gs.SLICE * itemsize
    assert p.rows % 4 == 0 and (p.groups - 1) * p.rows < block <= p.groups * p.rows
    assert p.smem == block_gs.BAR_BYTES + p.xbufs * xtile + p.stages * stage
    assert p.smem <= cap and 1 <= p.stages <= block_gs.MAX_STAGES
    assert p.stages == block_gs.MAX_STAGES or p.smem + stage > cap
    fits = block_gs.BAR_BYTES + p.per_cta * xtile + 2 * stage <= cap
    assert p.xbufs == (p.per_cta if fits else 1)


@pytest.mark.parametrize("const,value", [
    ("kSlice", block_gs.SLICE), ("kRows", block_gs.ROWS),
    ("kMaxCols", block_gs.MAX_COLS), ("kMaxStages", block_gs.MAX_STAGES),
    ("kBarBytes", block_gs.BAR_BYTES), ("kDepth", block_gs.DEPTH),
    ("kHeader", block_gs.HEADER)])
def test_block_gs_constants_match_the_source(const, value):
    """kernels/block_gs.py's copies of csrc/block_gs.cu's constants."""
    src = (Path(block_gs.__file__).parents[1] / "csrc" / "block_gs.cu"
           ).read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", src)
    assert m is not None and int(m.group(1)) == value


@pytest.mark.parametrize("n,block,k", [(16384, 128, 51), (3000, 20, 3),
                                       (1536, 64, 70), (256, 1, 1)])
def test_block_gs_scratch_holds_every_part(n, block, k):
    """The scratch: the zeroed counters, then DEPTH steps of parts at
    ((step % DEPTH, slice) * block + row) * k + column past them; the last
    part is its last float."""
    slices = -(-n // block_gs.SLICE)
    last = max(block_gs.HEADER + ((d * slices + sl) * block + r) * k + c
               for d in range(block_gs.DEPTH) for sl in (0, slices - 1)
               for r in (0, block - 1) for c in (0, k - 1))
    assert block_gs.scratch_floats(n, block, k) == last + 1


@pytest.mark.parametrize("block,rows", [(1, 4), (2, 4), (19, 20), (20, 20),
                                        (32, 32), (96, 32), (128, 32),
                                        (256, 32)])
def test_block_gs_plan_row_groups(block, rows):
    """Units hold ROWS rows of the block, or the block rounded up to 4 rows
    when it is smaller; at the main size each CTA owns two units."""
    p = block_gs.plan(2048, block, 51, 4, **H100)
    assert (p.rows, p.groups) == (rows, -(-block // rows))
    main = block_gs.plan(16384, 128, 51, 4, **H100)
    assert (main.rows, main.groups, main.units, main.grid, main.per_cta,
            main.xbufs) == (block_gs.ROWS, 4, 256, 132, 2, 2)


def test_block_gs_probe_parses_its_arguments():
    args = block_gs_probe.parse_args(["--label", "C1", "--repeats", "3"])
    assert (args.label, args.repeats) == ("C1", 3)
    args = block_gs_probe.parse_args([])
    assert (args.label, args.repeats) == ("", 5)
    with pytest.raises(SystemExit):
        block_gs_probe.parse_args(["--repeats", "0"])


@pytest.mark.parametrize("variant", sorted(block_gs_segments.VARIANTS))
def test_block_gs_segments_patches_the_source(variant):
    """Each variant of tune/block_gs_segments.py finds every line it
    patches in csrc/block_gs.cu exactly once, and adds the stamps' C
    entries; the tool refuses a variant it does not know."""
    src = (Path(block_gs.__file__).parents[1] / "csrc" / "block_gs.cu"
           ).read_text()
    out = block_gs_segments.patched(src, variant)
    assert out.count("clock64()") == 5 and "block_gs_seg_get" in out
    assert ("fmaf(avs[i][jj]" in out) == (variant in ("a_once", "no_loads"))
    assert ("const int need = s;" in out) == (variant == "no_lookahead")
    assert ("kRows = 64;" in out) == (variant == "rows64")
    with pytest.raises(ValueError, match="does not hold"):
        block_gs_segments.patched(src.replace("unit_parts(st,", "f(st,"),
                                  variant)
    with pytest.raises(SystemExit):
        block_gs_segments.main(["--variants", "stamps,bogus"])
