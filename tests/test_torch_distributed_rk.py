"""The rest of repro_torch's distributed engine at P = 1 (a world-size-1
gloo group in this process) against the reference's ``solve_distributed``
on a 1-device mesh: ``dense_rk`` and ``parallel_rk_solve``, the Kaczmarz
a2a exchange, ``overlap``, ``compress`` and ``partition="balanced"``; the
Schedule's new fields and their validation, the fallback warnings, the
vocabularies, the wire model, and ``x_star=None`` on every strategy row.

Both packages get the same problem arrays and the same pick streams (the
reference's, drawn as its strategies draw them, handed to the port as
``picks=``).  Tolerance: the reference's fused-vs-scan RK budget, as in
tests/test_torch_distributed.py: rel ||dx|| <= 1e-5, resid and err_sq
rtol 1e-4 / atol 1e-5; ``tau``, ``lag`` and ``bytes_per_round`` exactly.
At P = 1 nothing is exchanged, so the reference and the port both run
every overlapped, compressed and a2a variant bitwise as their lockstep,
f32, psum runs: the port is held to that exactly.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Schedule as RefSchedule  # noqa: E402
from repro.core import as_operator as ref_as_operator  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import kaczmarz as ref_kaczmarz  # noqa: E402
from repro.core import partition as ref_pt  # noqa: E402
from repro.core import random_lsq as ref_dense_lsq  # noqa: E402
from repro.core import random_sparse_lsq as ref_lsq  # noqa: E402
from repro.core import solve as ref_solve  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro.core.engine import sample_rows as ref_sample_rows  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed, engine, kaczmarz  # noqa: E402
from repro_torch.core.engine import Schedule, solve  # noqa: E402
from repro_torch.core.operators import (BlockBandedOp, DenseOp,  # noqa: E402
                                        EllOp, as_operator)
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


def _close(got, want):
    assert _rel(got.x, want.x) <= 1e-5
    for a, b in ((got.resid, want.resid), (got.err_sq, want.err_sq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert got.tau == int(want.tau)
    assert got.bytes_per_round == want.bytes_per_round


def _lsq(kind="sparse", k=2):
    if kind == "dense":
        r = ref_dense_lsq(96, 24, n_rhs=k, col_scale=0.5, seed=3)
    elif kind == "skewed":
        r = ref_lsq(128, 32, row_nnz=6, n_rhs=k, seed=0)
        A = np.array(r.A)
        A[:32] *= 20.0
        r = r._replace(A=jnp.asarray(A), b=jnp.asarray(A) @ r.x_true)
    else:
        r = ref_lsq(96, 32, row_nnz=5, n_rhs=k, seed=7)
    return r, convert.lsq_problem_from_numpy(
        r.A, r.b, r.x_star, r.x_true, r.sigma_min, r.sigma_max, "cpu")


def _spd(kind="sparse", k=2):
    if kind == "sparse":
        r = ref_spd.random_sparse_spd(64, row_nnz=6, n_rhs=k, seed=6)
    else:
        r = ref_spd.block_banded_spd(128, block=16, bands=1, n_rhs=k, seed=2)
    return r, convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                             r.lam_max, "cpu")


def _sparse_rk_picks(ref_op, key, rounds, steps, num_workers=1):
    """sparse_rk's streams as the reference draws them, (R, P, L)."""
    rn = ref_op.row_norms_sq()
    slab = rn.shape[0] // num_workers
    keys = jax.random.split(key, rounds)
    return np.stack([np.stack([np.asarray(ref_sample_rows(
        jax.random.fold_in(keys[r], w), rn[w * slab:(w + 1) * slab],
        steps)) for w in range(num_workers)]) for r in range(rounds)])


def _gs_picks(key, rounds, num_workers, steps, hi):
    keys = jax.random.split(key, rounds)
    return np.stack([np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(keys[r], w), (steps,), 0, hi))
        for w in range(num_workers)]) for r in range(rounds)])


def _dense_rk_picks(A, key, rounds, steps):
    """dense_rk's one global stream, (R, L) global row ids."""
    A = jnp.asarray(A, jnp.float32)
    rn = jnp.einsum("mn,mn->m", A, A)
    return np.asarray(ref_sample_rows(key, rn, rounds * steps)).reshape(
        rounds, steps)


# ---------------------------------------------------------------------------
# dense_rk and parallel_rk_solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage,steps", [(None, 40), (None, 96),
                                           ("bfloat16", 32)],
                         ids=["f32-40", "f32-96", "bf16-32"])
def test_dense_rk_matches_reference(group, storage, steps):
    """In bf16 storage the reference's ``_dense_rk`` sums its row norms in
    bf16 (``einsum`` on the stored matrix), where every operator's
    ``row_norms_sq`` (the port's too) is f32; so the port is held to the
    reference run in f32 on the bf16-rounded matrix, whose row norms are
    the port's."""
    r, p = _lsq("dense")
    key = jax.random.key(4)
    if storage:
        r = r._replace(A=r.A.astype(jnp.bfloat16).astype(jnp.float32))
    picks = _dense_rk_picks(r.A, key, ROUNDS, steps)
    want = ref_solve(r, key=key, format="dense", action="rk", beta=0.9,
                     mesh=make_host_mesh(1),
                     schedule=RefSchedule(rounds=ROUNDS, local_steps=steps))
    got = solve(p, format="dense", action="rk", beta=0.9,
                storage_dtype=storage, group=group,
                picks=torch.from_numpy(picks),
                schedule=Schedule(rounds=ROUNDS, local_steps=steps))
    _close(got, want)
    assert got.tau == 0 and got.lag is None
    assert (got.resid[-1] < got.resid[0]).all()


def test_parallel_rk_solve_matches_reference(group):
    r, p = _lsq("dense")
    key = jax.random.key(8)
    picks = _dense_rk_picks(r.A, key, ROUNDS, 48)
    want = ref_kaczmarz.parallel_rk_solve(
        r.A, r.b, jnp.zeros_like(r.x_star), r.x_star, key=key,
        mesh=make_host_mesh(1), rounds=ROUNDS, local_steps=48)
    got = kaczmarz.parallel_rk_solve(
        p.A, p.b, torch.zeros_like(p.x_star), p.x_star, group=group,
        rounds=ROUNDS, local_steps=48, picks=torch.from_numpy(picks))
    _close(got, want)
    engine_run = distributed.solve_distributed(
        DenseOp(p.A), p.b, torch.zeros_like(p.x_star), p.x_star,
        action="rk", group=group, rounds=ROUNDS, local_steps=48,
        sync="psum", picks=torch.from_numpy(picks))
    assert torch.equal(got.x, engine_run.x)
    # P = 1: the global stream is the sequential solver's, to roundoff
    seq = kaczmarz.rk_solve(p.A, p.b, torch.zeros_like(p.x_star), p.x_star,
                            num_iters=ROUNDS * 48,
                            picks=torch.from_numpy(picks.reshape(-1)))
    assert _rel(got.x, seq.x.numpy()) <= 1e-5


def test_dense_rk_seeded_stream_and_zero_row(group):
    """Without picks the global stream comes from the seed.  A foreign
    pick runs on the slab's appended zero row (b 0, rn 1) and leaves both
    carries bitwise as they were, whatever x holds; the row count must be
    a multiple of P."""
    from repro_torch.kernels import ops
    _, p = _lsq("dense")
    sched = Schedule(rounds=4, local_steps=48)
    a = solve(p, format="dense", group=group, seed=3, schedule=sched)
    b = solve(p, format="dense", group=group, seed=3, schedule=sched)
    assert torch.equal(a.x, b.x) and (a.resid[-1] < a.resid[0]).all()
    m, n = p.A.shape
    vals = torch.cat([p.A, p.A.new_zeros((1, n))])
    cols = torch.arange(n, dtype=torch.int32).expand(m + 1, n).contiguous()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((n, 2), generator=gen)
    d = torch.randn((n, 2), generator=gen)
    bz = torch.cat([p.b, p.b.new_zeros((1, 2))])
    rn = torch.cat([(p.A * p.A).sum(1), torch.ones(1)])
    x2, d2 = ops.sweep_rows_rk_delta(vals, cols, bz, rn, x, d,
                                     torch.full((7,), m), beta=0.9)
    np.testing.assert_array_equal(x2.numpy(), x.numpy())
    np.testing.assert_array_equal(d2.numpy(), d.numpy())
    with pytest.raises(ValueError, match=r"worker count \(5\) must divide "
                                         r"the row count \(96\)"):
        distributed._dense_rk(DenseOp(p.A), p.b, x, None, group=group,
                              rank=0, num_workers=5, rounds=1, local_steps=2,
                              beta=1.0, seed=0, picks=None)


# ---------------------------------------------------------------------------
# The Kaczmarz a2a exchange, overlap, compress, partition at P = 1
# ---------------------------------------------------------------------------

RK_VARIANTS = {
    "a2a": dict(sync="a2a"),
    "auto": dict(sync="auto"),
    "overlap": dict(sync="psum", overlap=True),
    "bf16": dict(sync="psum", compress="bf16"),
    "int8_ef": dict(sync="psum", compress="int8_ef"),
    "int8_ef-overlap-a2a": dict(sync="a2a", compress="int8_ef",
                                overlap=True),
}


@pytest.mark.parametrize("name", list(RK_VARIANTS))
@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_sparse_rk_variants_match_reference(group, name, fmt):
    kw = dict(RK_VARIANTS[name])
    sync = kw.pop("sync")
    r, p = (_spd("sparse") if fmt == "ell" else _lsq())
    fkw = dict(width=12) if fmt == "ell" else {}
    key = jax.random.key(5)
    ref_op = ref_as_operator(r.A, fmt, **fkw)
    picks = _sparse_rk_picks(ref_op, key, ROUNDS, 64)
    with warnings.catch_warnings(record=True) as wref:
        warnings.simplefilter("always")
        want = ref_solve(r, key=key, format=fmt, action="rk", beta=0.9,
                         mesh=make_host_mesh(1), sync=sync, fused=True,
                         schedule=RefSchedule(rounds=ROUNDS, local_steps=64,
                                              **kw), **fkw)
    with warnings.catch_warnings(record=True) as wgot:
        warnings.simplefilter("always")
        got = solve(p, format=fmt, action="rk", beta=0.9, group=group,
                    sync=sync, picks=torch.from_numpy(picks),
                    schedule=Schedule(rounds=ROUNDS, local_steps=64, **kw),
                    **fkw)
    _close(got, want)
    lockstep = solve(p, format=fmt, action="rk", beta=0.9, group=group,
                     sync="psum", picks=torch.from_numpy(picks),
                     schedule=Schedule(rounds=ROUNDS, local_steps=64), **fkw)
    for f in ("x", "resid", "err_sq"):
        assert torch.equal(getattr(got, f), getattr(lockstep, f)), f
    if kw.get("overlap"):
        assert got.lag.tolist() == np.asarray(want.lag).tolist() == [0] * 3
    else:
        assert got.lag is None and want.lag is None
    # the a2a + compress warning is the reference's, and only then
    said = [str(w.message) for w in wgot if "bitwise" in str(w.message)]
    assert len(said) == (1 if kw.get("compress") and sync in ("a2a", "auto")
                         else 0)
    assert said == [str(w.message) for w in wref
                    if "bitwise" in str(w.message)]


GS_VARIANTS = {
    "sparse_gs-allgather": ("csr", "sparse", "allgather", {}),
    "sparse_gs-a2a": ("ell", "sparse", "a2a", dict(width=12)),
    "halo_gs": ("banded", "banded", "halo", dict(block=16, bands=1)),
    "halo_gs-bf16": ("banded", "banded", "halo", dict(block=16, bands=1)),
}


@pytest.mark.parametrize("name", list(GS_VARIANTS))
def test_gs_overlap_and_compress_match_reference(group, name):
    fmt, kind, sync, fkw = GS_VARIANTS[name]
    sched_kw = dict(overlap=True)
    if name.endswith("bf16"):
        sched_kw["compress"] = "bf16"
    r, p = _spd(kind)
    key = jax.random.key(6)
    n = r.A.shape[0]
    steps = 8 if fmt == "banded" else 64
    hi = n // fkw["block"] if fmt == "banded" else n
    picks = _gs_picks(key, ROUNDS, 1, steps, hi)
    want = ref_solve(r, key=key, format=fmt, action="gs", beta=0.9,
                     mesh=make_host_mesh(1), sync=sync, fused=True,
                     schedule=RefSchedule(rounds=ROUNDS, local_steps=steps,
                                          **sched_kw), **fkw)
    got = solve(p, format=fmt, action="gs", beta=0.9, group=group,
                sync=sync, picks=torch.from_numpy(picks),
                schedule=Schedule(rounds=ROUNDS, local_steps=steps,
                                  **sched_kw), **fkw)
    _close(got, want)
    assert got.lag.tolist() == np.asarray(want.lag).tolist() == [0] * 3
    lockstep = solve(p, format=fmt, action="gs", beta=0.9, group=group,
                     sync=sync, picks=torch.from_numpy(picks),
                     schedule=Schedule(rounds=ROUNDS, local_steps=steps),
                     **fkw)
    for f in ("x", "resid", "err_sq"):
        assert torch.equal(getattr(got, f), getattr(lockstep, f)), f


@pytest.mark.parametrize("action", ["rk", "gs"])
def test_balanced_partition_matches_reference(group, action):
    """The permuted problem's streams (the reference's, drawn on its
    permuted operator); the GS iterate comes back in the original row
    order, the RK iterate was never permuted."""
    r, p = _lsq("skewed") if action == "rk" else _spd("sparse")
    key = jax.random.key(2)
    ref_op = ref_as_operator(r.A, "csr")
    perm_op, *_ = ref_pt.apply_partition(
        ref_op, r.b, jnp.zeros_like(r.x_star), r.x_star, action=action,
        num_slabs=1)
    picks = (_sparse_rk_picks(perm_op, key, ROUNDS, 64) if action == "rk"
             else _gs_picks(key, ROUNDS, 1, 64, r.A.shape[0]))
    sched = dict(rounds=ROUNDS, local_steps=64, partition="balanced")
    want = ref_solve(r, key=key, format="csr", action=action, beta=0.8,
                     mesh=make_host_mesh(1), sync="auto", fused=True,
                     schedule=RefSchedule(**sched))
    got = solve(p, format="csr", action=action, beta=0.8, group=group,
                picks=torch.from_numpy(picks), schedule=Schedule(**sched))
    _close(got, want)
    assert (got.resid[-1] < got.resid[0]).all()


# ---------------------------------------------------------------------------
# Schedule, vocabularies, fallbacks, wire model
# ---------------------------------------------------------------------------

def test_vocabularies_and_schedule_equal_reference():
    assert engine.PARTITIONS == ref_engine.PARTITIONS
    assert engine.COMPRESS_MODES == ref_engine.COMPRESS_MODES
    for action in ("gs", "rk"):
        for formats in (None, ("DenseOp", "CsrOp"), ("BlockBandedOp",)):
            assert (engine.supported_syncs(action, formats)
                    == ref_engine.supported_syncs(action, formats))
    assert (distributed._OVERLAP_STRATEGIES
            == ref_engine._OVERLAP_STRATEGIES)
    assert (distributed._COMPRESS_STRATEGIES
            == ref_engine._COMPRESS_STRATEGIES)
    sched = Schedule(rounds=4, local_steps=8, overlap=True)
    ref = RefSchedule(rounds=4, local_steps=8, overlap=True)
    for kw in ({}, dict(shared_stream=True), dict(local_sampling=True)):
        assert sched.effective_tau(4, **kw) == ref.effective_tau(4, **kw)
    assert Schedule(num_iters=8, tau=3).effective_tau(4) == 3


BAD = [
    (dict(rounds=2, local_steps=4, compress="fp8"), "unknown compress"),
    (dict(rounds=2, local_steps=4, partition="graph"), "unknown partition"),
    (dict(num_iters=10, compress="bf16"), "distributed-schedule option"),
    (dict(num_iters=10, overlap=True), "overlap=True is a distributed"),
    (dict(num_iters=10, partition="balanced"), "distributed-schedule"),
]


@pytest.mark.parametrize("fields,match", BAD,
                         ids=["compress", "partition", "seq-compress",
                              "seq-overlap", "seq-partition"])
def test_schedule_validation_as_reference(fields, match):
    with pytest.raises(ValueError, match=match):
        RefSchedule(**fields).validate()
    with pytest.raises(ValueError, match=match):
        Schedule(**fields).validate()


def test_unknown_compress_raises_in_the_engine(group):
    _, p = _lsq()
    with pytest.raises(ValueError, match="unknown compress"):
        distributed.solve_distributed(
            as_operator(p.A, "csr"), p.b, torch.zeros_like(p.x_star), None,
            action="rk", group=group, rounds=1, local_steps=4, seed=0,
            compress="fp8")


# strategy rows without an overlapped variant / a compressed wire: the
# warning, and the lockstep / f32 run bitwise
FALLBACKS = [
    ("dense_gs", "gs", "dense", dict(gs_block=16)),
    ("banded_gs", "gs", "banded", dict(block=16, bands=1, sync="allgather")),
    ("banded_rk", "rk", "banded", dict(block=16, bands=1)),
    ("dense_rk", "rk", "dense", {}),
    ("sparse_gs", "gs", "csr", {}),
]


@pytest.mark.parametrize("kind,action,fmt,kw", FALLBACKS,
                         ids=[f[0] for f in FALLBACKS])
def test_fallbacks_warn_and_run_exactly(group, kind, action, fmt, kw):
    _, p = _spd("banded")
    sched = dict(rounds=ROUNDS, local_steps=4)
    base = solve(p, format=fmt, action=action, group=group, seed=3,
                 schedule=Schedule(**sched), **kw)
    for extra, phrase in ((dict(overlap=True), "no overlapped-sync variant"),
                          (dict(compress="bf16"), "no compressed wire")):
        if (extra.get("overlap") and kind in
                distributed._OVERLAP_STRATEGIES):
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = solve(p, format=fmt, action=action, group=group, seed=3,
                        schedule=Schedule(**sched, **extra), **kw)
        msgs = [str(w.message) for w in caught]
        assert any(phrase in m and repr(kind) in m for m in msgs), msgs
        for f in ("x", "resid", "err_sq"):
            assert torch.equal(getattr(got, f), getattr(base, f)), f
        assert got.lag is None and got.tau == base.tau
        assert got.bytes_per_round == base.bytes_per_round


def test_wire_model_equals_reference():
    """bytes_per_round of every strategy row under every codec, at P = 4,
    the a2a rows on a two-offset schedule; and the payload sizes."""
    bop = ref_as_operator(_spd("banded")[0].A, "banded", block=16, bands=1)
    need = np.eye(4, dtype=bool) | np.eye(4, k=1, dtype=bool) | np.eye(
        4, k=-1, dtype=bool)
    gs_sched, _ = distributed._a2a_plan(need, 4)
    rk_sched = distributed._rk_a2a_plan(need, 4)
    for size in (1, 255, 256, 257, 4096 * 51):
        for c in engine.COMPRESS_MODES:
            assert (distributed._payload_bytes(size, c)
                    == ref_engine._payload_bytes(size, c))
    for kind in ("dense_gs", "banded_gs", "halo_gs", "sparse_gs",
                 "dense_rk", "banded_rk", "sparse_rk"):
        for sync in ("allgather", "psum", "a2a"):
            sched = (rk_sched if kind == "sparse_rk" else gs_sched) \
                if sync == "a2a" else ()
            for c in engine.COMPRESS_MODES:
                want = ref_engine._sync_bytes_per_round(
                    kind, sync, c, op=bop, n=128, k=3, num_workers=4,
                    a2a_schedule=sched)
                got = distributed._sync_bytes_per_round(
                    kind, n=128, k=3, num_workers=4, sync=sync,
                    halo=bop.bands * bop.block, a2a_schedule=sched,
                    compress=c)
                assert got == want > 0, (kind, sync, c)
    # the chain's reduce and broadcast pairs: 6 each
    assert [len(p) for p in rk_sched[0]] == [3, 0, 3]
    assert [len(p) for p in rk_sched[1]] == [3, 0, 3]


def test_x_star_none_on_every_strategy_row(group):
    """Every row of the table runs with ``x_star=None``: NaN err_sq,
    finite residuals and iterate (the reference's own check)."""
    r, p = _spd("banded")
    A = p.A
    csr = as_operator(A, "csr")
    ops = {"DenseOp": DenseOp(A),
           "BlockBandedOp": as_operator(A, "banded", block=16, bands=1),
           "CsrOp": csr, "EllOp": EllOp(*csr.padded_rows())}
    assert isinstance(ops["BlockBandedOp"], BlockBandedOp)
    rows = sorted(distributed._DISTRIBUTED_STRATEGIES)
    assert rows == sorted(ref_engine._DISTRIBUTED_STRATEGIES)
    for action, fmt, sync in rows:
        res = distributed.solve_distributed(
            ops[fmt], p.b, torch.zeros_like(p.b), None, action=action,
            group=group, sync=sync, seed=7, rounds=3, local_steps=4)
        row = (action, fmt, sync)
        assert torch.isnan(res.err_sq).all(), row
        assert torch.isfinite(res.resid).all(), row
        assert torch.isfinite(res.x).all(), row
