"""repro_torch's distributed engine at P = 1 (a world-size-1 gloo group in
this process) against the reference's ``solve_distributed`` on a
1-device mesh, the two local-phase kernels' plain versions against the
reference's Pallas kernels (interpret mode), and the engine's errors.

Both packages get the same problem arrays and the same pick streams (the
reference's, drawn as its strategies draw them, handed to the port as
``picks=``).  Tolerance: the reference's own fused-vs-scan RK budget
(tests/test_sweep_kernels.py): rel ||dx|| <= 1e-5, resid and err_sq
rtol 1e-4 / atol 1e-5; ``tau`` and ``bytes_per_round`` exactly.  Within
the port, the plain versions' contracts hold bitwise: from x = d = 0 the
two carries end equal, a gate of 0 leaves both windows unchanged, and a
column does not depend on how many columns ride along.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import Schedule as RefSchedule  # noqa: E402
from repro.core import as_operator as ref_as_operator  # noqa: E402
from repro.core import random_sparse_lsq as ref_lsq  # noqa: E402
from repro.core import solve as ref_solve  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro.core.engine import sample_rows as ref_sample_rows  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import (Schedule, scheduled_tau,  # noqa: E402
                                     solve)
from repro_torch.core.operators import as_operator  # noqa: E402
from repro_torch.kernels import ref, ref_banded  # noqa: E402
from repro_torch.launch.mesh import process_group, run_workers  # noqa: E402

ROUNDS = 3


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with process_group("gloo", tmp_path_factory.mktemp("pg")) as g:
        yield g


def _t(a):
    return convert._tensor(a, "cpu")


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got.double().numpy() - want) / (
        np.linalg.norm(want) or 1.0)


# ---------------------------------------------------------------------------
# The local-phase kernels' plain versions against the reference kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", [None, "bfloat16"], ids=["f32", "bf16"])
def test_sweep_rows_rk_delta_matches_reference(storage):
    r = ref_lsq(96, 32, row_nnz=5, n_rhs=3, seed=7)
    op = ref_as_operator(r.A, "csr", storage_dtype=storage)
    vals, cols = op.padded_rows()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 3)).astype(np.float32)
    d = rng.standard_normal((32, 3)).astype(np.float32)
    rn = np.asarray(op.row_norms_sq())
    picks = rng.integers(0, 96, 200).astype(np.int32)
    wx, wd = ref_ops.sweep_rows_rk_delta(vals, cols, r.b, rn, x, d, picks,
                                         beta=0.9)
    gx, gd = ref.sweep_rows_rk_delta_ref(
        _t(vals), _t(cols), _t(r.b), _t(rn), _t(x), _t(d),
        torch.from_numpy(picks), beta=0.9)
    if storage:
        assert (_t(vals).dtype, _t(cols).dtype) == (torch.bfloat16,
                                                    torch.int16)
    assert _rel(gx, wx) <= 1e-5 and _rel(gd, wd) <= 1e-5


def _banded_case(k=3, nb=6, block=8, bands=2, seed=1):
    """Packed tiles of a reference block-banded operator, a random window
    pair, row norms, picks and mixed gates (numpy)."""
    A = ref_spd.block_banded_spd(nb * block, block=block, bands=bands,
                                 seed=seed).A
    tiles = np.array(ref_as_operator(A, "banded", block=block,
                                       bands=bands).packed_band_tiles())
    rng = np.random.default_rng(seed)
    win = (nb + 2 * bands) * block
    return dict(
        A_bands=tiles,
        b=rng.standard_normal((nb * block, k)).astype(np.float32),
        rn=(tiles.astype(np.float64) ** 2).sum(axis=(1, 3)).astype(
            np.float32),
        xw=rng.standard_normal((win, k)).astype(np.float32),
        dw=rng.standard_normal((win, k)).astype(np.float32),
        picks=rng.integers(0, nb, 24).astype(np.int32),
        gates=rng.integers(0, 2, 24).astype(np.int32)), block, bands


def test_banded_rk_sweep_matches_reference():
    case, block, bands = _banded_case()
    assert 0 < case["gates"].sum() < case["gates"].size       # mixed
    wx, wd = ref_ops.banded_rk_sweep(*case.values(), block=block,
                                     bands=bands, beta=0.9)
    gx, gd = ref_banded.banded_rk_sweep_ref(
        *(torch.from_numpy(v) for v in case.values()), block=block,
        bands=bands, beta=0.9)
    assert _rel(gx, wx) <= 1e-5 and _rel(gd, wd) <= 1e-5


def test_two_carry_plain_versions_exact_contracts():
    # sweep_rows_rk_delta: x == d from zero; column 0 independent of k
    r = ref_lsq(64, 24, row_nnz=4, n_rhs=3, seed=2)
    vals, cols = (_t(a) for a in ref_as_operator(r.A, "csr").padded_rows())
    b = _t(r.b)
    rn = (vals * vals).sum(1)
    picks = torch.from_numpy(np.random.default_rng(3).integers(0, 64, 150))
    zero = torch.zeros((24, 3))
    x, d = ref.sweep_rows_rk_delta_ref(vals, cols, b, rn, zero, zero, picks,
                                       beta=0.8)
    assert torch.equal(x, d) and x.abs().sum() > 0
    x1, d1 = ref.sweep_rows_rk_delta_ref(vals, cols, b[:, :1].contiguous(),
                                         rn, zero[:, :1], zero[:, :1], picks,
                                         beta=0.8)
    assert torch.equal(x1[:, 0], x[:, 0]) and torch.equal(d1[:, 0], d[:, 0])

    # banded_rk_sweep: gate 0 is a no-op; x == d from zero with gates 1;
    # column 0 independent of k
    case, block, bands = _banded_case()
    t = {name: torch.from_numpy(v) for name, v in case.items()}
    kw = dict(block=block, bands=bands, beta=0.9)
    args = (t["A_bands"], t["b"], t["rn"])
    xw, dw = ref_banded.banded_rk_sweep_ref(
        *args, t["xw"], t["dw"], t["picks"], torch.zeros_like(t["gates"]),
        **kw)
    assert torch.equal(xw, t["xw"]) and torch.equal(dw, t["dw"])
    zw = torch.zeros_like(t["xw"])
    ones = torch.ones_like(t["gates"])
    xw, dw = ref_banded.banded_rk_sweep_ref(*args, zw, zw, t["picks"], ones,
                                            **kw)
    assert torch.equal(xw, dw) and xw.abs().sum() > 0
    x1, _ = ref_banded.banded_rk_sweep_ref(
        t["A_bands"], t["b"][:, :1].contiguous(), t["rn"],
        zw[:, :1].contiguous(), zw[:, :1].contiguous(), t["picks"], ones,
        **kw)
    assert torch.equal(x1[:, 0], xw[:, 0])


# ---------------------------------------------------------------------------
# solve(..., group=) against the reference's solve_distributed, P = 1
# ---------------------------------------------------------------------------

# (strategy, format, problem, storage, local_steps, format arguments)
SOLVES = [
    ("sparse_rk", "csr", "lsq", None, 64, {}),
    ("sparse_rk", "csr", "lsq", "bfloat16", 64, {}),
    ("sparse_rk", "csr", "lsq_zero_rows", None, 48, {}),
    ("sparse_rk", "ell", "spd", None, 64, dict(width=12)),
    ("banded_rk", "banded", "banded", None, 8, dict(block=16, bands=1)),
    ("banded_rk", "banded", "banded2", "bfloat16", 6,
     dict(block=8, bands=2)),
]
SOLVE_IDS = ["csr-f32", "csr-bf16", "csr-zero-rows", "ell-f32",
             "banded-f32", "banded-bf16-bands2"]


def _problem(kind, k=2):
    """(reference problem, port problem on the CPU) with identical arrays."""
    if kind.startswith("lsq"):
        r = ref_lsq(96, 32, row_nnz=5, n_rhs=k, seed=7)
        if kind == "lsq_zero_rows":
            keep = (np.arange(96) % 3 != 0)[:, None].astype(np.float32)
            A = np.array(r.A) * keep
            r = r._replace(A=jnp.asarray(A), b=jnp.asarray(A) @ r.x_true)
        return r, convert.lsq_problem_from_numpy(
            r.A, r.b, r.x_star, r.x_true, r.sigma_min, r.sigma_max, "cpu")
    if kind == "spd":
        r = ref_spd.random_sparse_spd(64, row_nnz=6, n_rhs=k, seed=6)
    elif kind == "banded":
        r = ref_spd.block_banded_spd(128, block=16, bands=1, n_rhs=k, seed=2)
    else:
        r = ref_spd.block_banded_spd(64, block=8, bands=2, n_rhs=k, seed=3)
    return r, convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                             r.lam_max, "cpu")


def _reference_picks(strategy, ref_op, key, rounds, local_steps,
                     num_workers=1):
    """The reference's streams as its strategies draw them: per rank
    ``sample_rows(fold_in(split(key, R)[r], w), rn_slab, L)`` for
    sparse_rk, (R, P, L); ``sample_rows(key, panel_w, R * L)`` for
    banded_rk, (R, L)."""
    rn = ref_op.row_norms_sq()
    if strategy == "banded_rk":
        return np.asarray(ref_sample_rows(key, jnp.sum(rn, axis=1),
                                          rounds * local_steps)).reshape(
                                              rounds, local_steps)
    slab = rn.shape[0] // num_workers
    keys = jax.random.split(key, rounds)
    return np.stack([np.stack([np.asarray(ref_sample_rows(
        jax.random.fold_in(keys[r], w), rn[w * slab:(w + 1) * slab],
        local_steps)) for w in range(num_workers)]) for r in range(rounds)])


# The reference's two engines of sparse_rk disagree by about 4e-4 (rel) in
# bf16 storage: its scan rounds beta * v to bf16 before widening, its fused
# kernel (and the port) widen v first (ROADMAP queue 3, fault d).  The port
# is held to the fused engine there.
PAIRS = [(case, fused) for case in zip(SOLVE_IDS, SOLVES)
         for fused in (False, True)
         if fused or case[0] != "csr-bf16"]


@pytest.mark.parametrize(
    "strategy,fmt,kind,storage,steps,kw,ref_fused",
    [(*case, fused) for (_, case), fused in PAIRS],
    ids=[f"{cid}-{'fused' if fused else 'scan'}" for (cid, _), fused in PAIRS])
def test_solve_matches_reference_at_p1(group, strategy, fmt, kind, storage,
                                       steps, kw, ref_fused):
    r, p = _problem(kind)
    key = jax.random.key(5)
    ref_op = ref_as_operator(r.A, fmt, storage_dtype=storage, **kw)
    picks = _reference_picks(strategy, ref_op, key, ROUNDS, steps)
    want = ref_solve(r, key=key, format=fmt, action="rk", beta=0.9,
                     storage_dtype=storage, mesh=make_host_mesh(1),
                     sync="psum", fused=ref_fused,
                     schedule=RefSchedule(rounds=ROUNDS, local_steps=steps),
                     **kw)
    got = solve(p, format=fmt, action="rk", beta=0.9, storage_dtype=storage,
                group=group, sync="psum", picks=torch.from_numpy(picks),
                schedule=Schedule(rounds=ROUNDS, local_steps=steps), **kw)
    assert _rel(got.x, want.x) <= 1e-5
    for a, b in ((got.resid, want.resid), (got.err_sq, want.err_sq)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert got.tau == int(want.tau) == 0
    assert got.bytes_per_round == want.bytes_per_round == 0.0
    assert got.lag is None


def test_seeded_streams_are_reproducible_and_converge(group):
    """Without picks the streams come from the seed: the same seed gives
    the same iterate, another seed another one, and both converge."""
    _, p = _problem("lsq")
    sched = Schedule(rounds=8, local_steps=288)
    runs = [solve(p, format="csr", group=group, sync="psum", seed=s,
                  schedule=sched) for s in (1, 1, 2)]
    assert torch.equal(runs[0].x, runs[1].x)
    assert not torch.equal(runs[0].x, runs[2].x)
    for res in runs:
        assert (res.resid[-1] < 1e-2 * res.resid[0]).all()
    _, bp = _problem("banded")
    res = solve(bp, format="banded", action="rk", block=16, bands=1,
                beta=0.9, group=group, seed=3,
                schedule=Schedule(rounds=12, local_steps=8))
    assert (res.resid[-1] < 1e-2 * res.resid[0]).all()


def test_all_zero_slab_is_safe(group):
    """An all-zero operator: the picks fall back to uniform, rn_safe
    divides by 1, every update is an exact zero and nothing is NaN."""
    _, p = _problem("lsq")
    p = p._replace(A=torch.zeros_like(p.A), b=torch.zeros_like(p.b))
    res = solve(p, format="csr", group=group, sync="psum", seed=0,
                schedule=Schedule(rounds=2, local_steps=32))
    assert not res.x.any() and not res.resid.any()
    assert torch.isfinite(res.err_sq).all()


def test_tau_and_bytes_follow_the_schedule():
    """scheduled_tau is the reference's rule; bytes are 0 at P = 1 and
    4 * n * k (the f32 delta) above it."""
    from repro.core.engine import scheduled_tau as ref_tau
    for P, L in ((1, 8), (4, 8), (3, 5)):
        for kw in (dict(), dict(shared_stream=True),
                   dict(local_sampling=True),
                   dict(shared_stream=True, overlap=True),
                   dict(local_sampling=True, overlap=True)):
            assert scheduled_tau(P, L, **kw) == ref_tau(P, L, **kw)
    for kind in ("sparse_rk", "banded_rk"):
        assert distributed._sync_bytes_per_round(
            kind, n=64, k=3, num_workers=1) == 0.0
        assert distributed._sync_bytes_per_round(
            kind, n=64, k=3, num_workers=4) == 4.0 * 64 * 3


BAD_SCHEDULES = [
    (dict(num_iters=16, rounds=2, local_steps=4), "ambiguous Schedule"),
    (dict(rounds=2), "needs local_steps > 0"),
    (dict(num_iters=16, local_steps=4), "local_steps without rounds"),
]


@pytest.mark.parametrize("fields,match", BAD_SCHEDULES,
                         ids=["mixture", "no-local-steps", "steps-only"])
def test_schedule_mode_mixtures_rejected_as_reference(fields, match):
    with pytest.raises(ValueError, match=match):
        RefSchedule(**fields).validate()
    with pytest.raises(ValueError, match=match):
        Schedule(**fields).validate()
    assert Schedule(rounds=2, local_steps=4).distributed
    assert not Schedule(num_iters=4).distributed


def test_distributed_errors(group):
    _, p = _problem("lsq")
    sched = Schedule(rounds=2, local_steps=8)
    with pytest.raises(ValueError, match="needs a group"):
        solve(p, format="csr", schedule=sched, seed=0)
    with pytest.raises(ValueError, match="seed=.*not from a generator"):
        solve(p, format="csr", schedule=sched, group=group, sync="psum",
              generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs a seed or picks"):
        solve(p, format="csr", schedule=sched, group=group, sync="psum")
    with pytest.raises(ValueError, match="generator=.*not from seed="):
        solve(p, format="csr", schedule=Schedule(num_iters=8), seed=0)
    # a row no strategy serves: the enumerating message, listing the rows
    for fmt, action, sync in (("dense", "rk", "a2a"), ("csr", "gs", "halo"),
                              ("banded", "gs", "a2a"), ("csr", "rk", "halo")):
        prob = _problem("banded")[1] if fmt == "banded" else p
        with pytest.raises(NotImplementedError) as e:
            solve(prob, format=fmt, action=action, schedule=sched,
                  group=group, sync=sync, seed=0, block=16, bands=1)
        msg = str(e.value)
        assert "no distributed strategy" in msg
        assert all(f"format={f}" in msg
                   for f in ("BlockBandedOp", "CsrOp", "DenseOp", "EllOp"))
    # picks of the wrong shape or range
    with pytest.raises(ValueError, match="picks has shape"):
        solve(p, format="csr", schedule=sched, group=group, sync="psum",
              picks=torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(IndexError, match=r"allowed \[0, 96\)"):
        solve(p, format="csr", schedule=sched, group=group, sync="psum",
              picks=torch.full((2, 1, 8), 96))


def test_row_count_must_divide():
    """m % P raises the reference's message (P = 4 stands in a fake group
    of four: the check comes before any collective)."""
    _, p = _problem("lsq")
    op = as_operator(p.A[:94].contiguous(), "csr")
    with pytest.raises(ValueError, match=r"worker count \(4\) must divide "
                                         r"the row count \(94\)"):
        distributed._sparse_rk(op, p.b[:94], torch.zeros((32, 2)), None,
                               group=None, rank=0, num_workers=4, rounds=1,
                               local_steps=4, beta=1.0, seed=0, picks=None)
    _, bp = _problem("banded")
    bop = as_operator(bp.A, "banded", block=16, bands=1)
    with pytest.raises(ValueError, match=r"must divide the block-row count"):
        distributed._banded_rk(bop, bp.b, torch.zeros_like(bp.b), None,
                               group=None, rank=0, num_workers=3, rounds=1,
                               local_steps=4, beta=1.0, seed=0, picks=None)


def test_backend_is_explicit_and_checked(tmp_path):
    """No automatic switch: an unknown backend raises, and nccl asks for
    a card per rank (none here)."""
    with pytest.raises(ValueError, match="unknown backend"):
        run_workers(print, 2, backend="auto", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        with process_group("mpi", tmp_path):
            pass
    with pytest.raises(ValueError, match="needs 2 cards"):
        run_workers(print, 2, backend="nccl", device="cuda")
