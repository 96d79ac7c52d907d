"""repro_torch's distributed Gauss-Seidel at P = 1 (a world-size-1 gloo
group in this process) against the reference's ``solve_distributed`` on a
1-device mesh, its layout queries against the reference's, the
``parallel_rgs`` wrappers against the engine, and the engine's errors.

Both packages get the same problem arrays and the same pick streams (the
reference's ``randint(fold_in(split(key, R)[r], w), (L,), 0, hi)``, handed
to the port as ``picks=``).  Tolerance: rel ||dx|| <= 1e-5, resid and
err_sq rtol 1e-4 / atol 1e-5 for every strategy (``dense_gs`` too: its
kernel adds each step into x where the reference keeps the round's delta
apart, a difference of roundoff); ``tau`` and ``bytes_per_round`` exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Schedule as RefSchedule  # noqa: E402
from repro.core import as_operator as ref_as_operator  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import parallel_rgs as ref_parallel_rgs  # noqa: E402
from repro.core import solve as ref_solve  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed, parallel_rgs  # noqa: E402
from repro_torch.core.engine import Schedule, solve  # noqa: E402
from repro_torch.core.operators import (BlockBandedOp, DenseOp,  # noqa: E402
                                        as_operator, slab_neighbor_matrix)
from repro_torch.launch.mesh import process_group  # noqa: E402

ROUNDS = 3


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with process_group("gloo", tmp_path_factory.mktemp("pg")) as g:
        yield g


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got.double().numpy() - want) / (
        np.linalg.norm(want) or 1.0)


def _problem(kind, k=2):
    """(reference problem, port problem on the CPU) with identical
    arrays."""
    if kind == "sparse":
        r = ref_spd.random_sparse_spd(64, row_nnz=6, n_rhs=k, seed=6)
    elif kind == "laplacian":
        r = ref_spd.laplacian_spd(8, n_rhs=k, seed=4)
    else:
        r = ref_spd.block_banded_spd(128, block=16, bands=1, n_rhs=k, seed=2)
    return r, convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                             r.lam_max, "cpu")


def reference_gs_picks(key, rounds, num_workers, local_steps, hi):
    """The reference GS strategies' streams, (R, P, L): rank w of round r
    draws ``randint(fold_in(split(key, R)[r], w), (L,), 0, hi)``."""
    keys = jax.random.split(key, rounds)
    return np.stack([np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(keys[r], w), (local_steps,), 0, hi))
        for w in range(num_workers)]) for r in range(rounds)])


# (strategy, format, problem, sync, gs_block, storage, local_steps, kwargs)
CASES = {
    "sparse-csr-allgather": ("sparse_gs", "csr", "sparse", "allgather", 1,
                             None, 64, {}),
    "sparse-csr-bf16-auto": ("sparse_gs", "csr", "sparse", "auto", 1,
                             "bfloat16", 48, {}),
    "sparse-ell-a2a": ("sparse_gs", "ell", "sparse", "a2a", 1, None, 64,
                       dict(width=12)),
    "sparse-ell-laplacian-auto": ("sparse_gs", "ell", "laplacian", "auto", 1,
                                  None, 40, dict(width=5)),
    "banded": ("banded_gs", "banded", "banded", "allgather", 1, None, 8,
               dict(block=16, bands=1)),
    "halo": ("halo_gs", "banded", "banded", "halo", 1, None, 8,
             dict(block=16, bands=1)),
    "halo-auto": ("halo_gs", "banded", "banded", "auto", 1, None, 6,
                  dict(block=16, bands=1)),
    "dense-block1": ("dense_gs", "dense", "sparse", "auto", 1, None, 64, {}),
    "dense-block4": ("dense_gs", "dense", "banded", "allgather", 4, None, 24,
                     {}),
}


def _hi(strategy, fmt_kw, n, gs_block):
    if strategy in ("banded_gs", "halo_gs"):
        return n // fmt_kw["block"]
    return n // gs_block


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_reference_at_p1(group, name):
    strategy, fmt, kind, sync, gs_block, storage, steps, kw = CASES[name]
    r, p = _problem(kind)
    key = jax.random.key(5)
    picks = reference_gs_picks(key, ROUNDS, 1, steps,
                               _hi(strategy, kw, r.A.shape[0], gs_block))
    want = ref_solve(r, key=key, format=fmt, action="gs", beta=0.9,
                     storage_dtype=storage, mesh=make_host_mesh(1),
                     sync=sync, gs_block=gs_block,
                     schedule=RefSchedule(rounds=ROUNDS, local_steps=steps),
                     **kw)
    got = solve(p, format=fmt, action="gs", beta=0.9, storage_dtype=storage,
                group=group, sync=sync, gs_block=gs_block,
                picks=torch.from_numpy(picks),
                schedule=Schedule(rounds=ROUNDS, local_steps=steps), **kw)
    assert _rel(got.x, want.x) <= 1e-5
    for a, b in ((got.resid, want.resid), (got.err_sq, want.err_sq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert got.tau == int(want.tau) == 0
    assert got.bytes_per_round == want.bytes_per_round == 0.0
    assert got.lag is None
    # the residual falls: the local phases ran
    assert (got.resid[-1] < got.resid[0]).all()


@pytest.mark.parametrize("name", ["sparse-csr-allgather", "sparse-ell-a2a",
                                  "banded", "halo", "dense-block4"])
def test_column_zero_does_not_depend_on_k(group, name):
    """Column 0 of a k = 2 solve equals the k = 1 solve of that column
    exactly (x, err_sq and resid): no kernel or record sum of a strategy
    orders a column's arithmetic by k."""
    _, fmt, kind, sync, gs_block, storage, steps, kw = CASES[name]
    _, p = _problem(kind)
    run = dict(format=fmt, group=group, sync=sync, gs_block=gs_block,
               storage_dtype=storage, seed=9,
               schedule=Schedule(rounds=ROUNDS, local_steps=steps), **kw)
    full = solve(p, **run)
    one = solve(p._replace(b=p.b[:, :1].contiguous(),
                           x_star=p.x_star[:, :1].contiguous()), **run)
    for f in ("x", "err_sq", "resid"):
        assert torch.equal(getattr(full, f)[:, :1], getattr(one, f)), f


def test_without_x_star_and_without_metrics(group):
    """No x*: err_sq is NaN and the residual the reference's; with_metrics
    off: zero records and exactly the same iterate."""
    r, p = _problem("banded")
    key = jax.random.key(3)
    picks = reference_gs_picks(key, ROUNDS, 1, 8, 8)
    for sync in ("allgather", "halo"):
        want = ref_engine.solve_distributed(
            ref_as_operator(r.A, "banded", block=16, bands=1), r.b,
            np.zeros_like(r.b), None, action="gs", key=key,
            mesh=make_host_mesh(1), rounds=ROUNDS, local_steps=8, sync=sync)
        op = as_operator(p.A, "banded", block=16, bands=1)
        kw = dict(action="gs", group=group, rounds=ROUNDS, local_steps=8,
                  sync=sync, picks=torch.from_numpy(picks))
        got = distributed.solve_distributed(op, p.b, torch.zeros_like(p.b),
                                            None, **kw)
        assert torch.isnan(got.err_sq).all()
        assert np.isnan(np.asarray(want.err_sq)).all()
        np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid),
                                   rtol=1e-4, atol=1e-5)
        bare = distributed.solve_distributed(
            op, p.b, torch.zeros_like(p.b), p.x_star, with_metrics=False,
            **kw)
        assert torch.equal(bare.x, got.x)
        assert not bare.resid.any() and not bare.err_sq.any()


def test_seeded_streams_are_reproducible_and_converge(group):
    """Without picks each rank's stream comes from seed * P + rank: the
    same seed gives the same iterate, another seed another one, and every
    strategy converges."""
    _, p = _problem("sparse")
    sched = Schedule(rounds=12, local_steps=64)
    runs = [solve(p, format="csr", group=group, seed=s, schedule=sched)
            for s in (1, 1, 2)]
    assert torch.equal(runs[0].x, runs[1].x)
    assert not torch.equal(runs[0].x, runs[2].x)
    _, bp = _problem("banded")
    runs += [solve(bp, format="banded", block=16, bands=1, group=group,
                   seed=3, sync=sync, schedule=Schedule(rounds=8,
                                                        local_steps=8))
             for sync in ("allgather", "halo")]
    assert torch.equal(runs[-1].x, runs[-2].x)
    runs.append(solve(bp, format="dense", gs_block=4, group=group, seed=4,
                      schedule=Schedule(rounds=8, local_steps=32)))
    for res in runs:
        assert (res.resid[-1] < 1e-2 * res.resid[0]).all()


@pytest.mark.parametrize("fmt", ["csr", "ell"])
@pytest.mark.parametrize("workers", [1, 2, 4, 8])
def test_slab_neighbors_match_reference(fmt, workers):
    for kind in ("sparse", "laplacian"):
        r, p = _problem(kind)
        kw = dict(width=8) if fmt == "ell" else {}
        want = ref_as_operator(r.A, fmt, **kw).slab_neighbors(workers)
        op = as_operator(p.A, fmt, **kw)
        got = op.slab_neighbors(workers)
        assert got.dtype == np.bool_ and np.array_equal(got, want)
        assert op.slab_neighbors(workers) is got            # memoized


def test_layout_queries():
    """halo_width is the reference's on every format; the neighbor matrix
    refuses a partition that does not divide."""
    r, p = _problem("banded")
    for fmt, kw in (("dense", {}), ("csr", {}), ("ell", dict(width=8)),
                    ("banded", dict(block=16, bands=1))):
        assert (as_operator(p.A, fmt, **kw).halo_width
                == ref_as_operator(r.A, fmt, **kw).halo_width)
    assert as_operator(p.A, "banded", block=16, bands=1).halo_width == 16
    t = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"worker count \(3\) must divide"):
        slab_neighbor_matrix(t, t, t > 0, 64, 64, 3)


def test_sync_bytes_per_round_match_reference():
    """The GS rows of the wire model against the reference's, at P = 4
    (the a2a row on a two-rotation schedule)."""
    _, p = _problem("banded")
    op = as_operator(p.A, "banded", block=16, bands=1)
    need = as_operator(_problem("laplacian")[1].A, "csr").slab_neighbors(4)
    schedule, _ = distributed._a2a_plan(need, 4)
    assert [s for s, _ in schedule] == [1, 3]
    for kind, sync in (("dense_gs", "allgather"), ("banded_gs", "allgather"),
                       ("halo_gs", "halo"), ("sparse_gs", "allgather"),
                       ("sparse_gs", "a2a")):
        want = ref_engine._sync_bytes_per_round(
            kind, sync, "none", op=op, n=128, k=3, num_workers=4,
            a2a_schedule=schedule)
        got = distributed._sync_bytes_per_round(
            kind, n=128, k=3, num_workers=4, sync=sync, halo=op.halo_width,
            a2a_schedule=schedule)
        assert got == want > 0
        assert distributed._sync_bytes_per_round(
            kind, n=128, k=3, num_workers=1, sync=sync, halo=16) == 0.0


def test_parallel_rgs_wrappers_match_the_engine(group):
    """The three wrappers are the engine's dense_gs, banded_gs and halo_gs
    rows, bitwise; effective_tau is the reference's."""
    _, p = _problem("banded")
    x0 = torch.zeros_like(p.b)
    picks = torch.from_numpy(reference_gs_picks(jax.random.key(7), ROUNDS, 1,
                                                8, 8))
    common = dict(group=group, rounds=ROUNDS, local_steps=8, beta=0.8,
                  picks=picks)
    A_bands = as_operator(p.A, "banded", block=16, bands=1).A_bands
    pairs = [
        (parallel_rgs.parallel_rgs_solve(p.A, p.b, x0, p.x_star, block=16,
                                         **common),
         distributed.solve_distributed(DenseOp(p.A), p.b, x0, p.x_star,
                                       block=16, sync="allgather", **common)),
        (parallel_rgs.parallel_rgs_banded(A_bands, p.b, x0, p.x_star,
                                          block=16, bands=1, **common),
         distributed.solve_distributed(BlockBandedOp(A_bands, bands=1), p.b,
                                       x0, p.x_star, sync="allgather",
                                       **common)),
        (parallel_rgs.parallel_rgs_halo(A_bands, p.b, x0, block=16, bands=1,
                                        **common),
         distributed.solve_distributed(BlockBandedOp(A_bands, bands=1), p.b,
                                       x0, None, sync="halo", **common))]
    for got, want in pairs:
        for f in ("x", "resid", "err_sq"):
            assert torch.equal(getattr(got, f), getattr(want, f)) or (
                f == "err_sq" and torch.isnan(got.err_sq).all()
                and torch.isnan(want.err_sq).all())
    assert torch.isnan(pairs[2][0].err_sq).all()
    for P, L in ((1, 8), (4, 8), (3, 5)):
        assert (parallel_rgs.effective_tau(P, L)
                == ref_parallel_rgs.effective_tau(P, L))
    with pytest.raises(AssertionError):
        parallel_rgs.parallel_rgs_banded(A_bands, p.b, x0, None, block=8,
                                         bands=1, **common)


def test_errors_match_reference(group):
    """Block GS on a sparse format, and combinations no strategy serves,
    raise as the reference does (the enumerating message lists the
    port's rows, the reference's table)."""
    r, p = _problem("sparse")
    sched = Schedule(rounds=2, local_steps=8)
    msg = "block=2 is not supported for CsrOp"
    with pytest.raises(NotImplementedError, match=msg):
        ref_solve(r, key=jax.random.key(0), format="csr", gs_block=2,
                  mesh=make_host_mesh(1),
                  schedule=RefSchedule(rounds=2, local_steps=8))
    with pytest.raises(NotImplementedError, match=msg):
        solve(p, format="csr", gs_block=2, group=group, seed=0,
              schedule=sched)
    rb, bp = _problem("banded")
    for fmt, action, sync in (("dense", "gs", "halo"), ("csr", "gs", "halo"),
                              ("banded", "gs", "a2a"), ("dense", "gs", "a2a"),
                              ("ell", "gs", "psum"), ("banded", "rk", "halo")):
        with pytest.raises(NotImplementedError, match="no distributed "
                                                      "strategy"):
            ref_solve(rb, key=jax.random.key(0), format=fmt, action=action,
                      sync=sync, block=16, bands=1, width=8,
                      mesh=make_host_mesh(1),
                      schedule=RefSchedule(rounds=2, local_steps=8))
        with pytest.raises(NotImplementedError) as e:
            solve(bp, format=fmt, action=action, sync=sync, block=16,
                  bands=1, group=group, seed=0, schedule=sched)
        assert "no distributed strategy" in str(e.value)
        assert all(f"format={f}" in str(e.value) for f in (
            "BlockBandedOp", "CsrOp", "DenseOp", "EllOp"))
    assert (set(distributed._DISTRIBUTED_STRATEGIES.items())
            == set(ref_engine._DISTRIBUTED_STRATEGIES.items()))


def test_partition_checks():
    """A worker count that does not divide the rows (or blocks), and a
    halo wider than a slab, raise before any collective (P stands in a
    fake group: the checks come first)."""
    _, p = _problem("sparse")
    fake = dict(group=None, rank=0, rounds=1, local_steps=4, beta=1.0,
                seed=0, picks=None, with_metrics=True)
    csr = as_operator(p.A[:60].contiguous(), "csr")
    with pytest.raises(ValueError, match=r"worker count \(8\) must divide "
                                         r"the row count \(60\)"):
        distributed._sparse_gs(csr, p.b[:60], torch.zeros((60, 2)), None,
                               num_workers=8, sync="allgather",
                               a2a_schedule=(), a2a_masks=None, **fake)
    _, bp = _problem("banded")
    with pytest.raises(ValueError, match=r"times the block \(4\) must "
                                         r"divide the row count \(128\)"):
        distributed._dense_gs(DenseOp(bp.A), bp.b, torch.zeros_like(bp.b),
                              None, block=4, num_workers=3, **fake)
    band = as_operator(bp.A, "banded", block=16, bands=1)
    for run in (distributed._banded_gs, distributed._halo_gs):
        with pytest.raises(ValueError, match="must divide the block-row "
                                             r"count \(8\)"):
            run(band, bp.b, torch.zeros_like(bp.b), None, num_workers=3,
                **fake)
    wide = as_operator(bp.A, "banded", block=16, bands=2)
    with pytest.raises(ValueError, match=r"bands\*block <= slab \(got "
                                         r"2\*16 = 32 > 16\)"):
        distributed._halo_gs(wide, bp.b, torch.zeros_like(bp.b), None,
                             num_workers=8, **fake)
