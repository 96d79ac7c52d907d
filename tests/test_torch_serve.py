"""repro_torch's serving layer (``serve/``, ``launch.serve``) and the lazy
kernel build under threads.

The port's service is held against the reference's ``SolverService`` on
the same matrix, RHS blocks and tolerances, with the reference's
``jax.random`` stream handed to the port's engine as ``picks=`` (the
port's own stream is a ``torch.Generator``'s, a different one): the
tolerances bitwise, x within rtol 1e-5 (relative norm) and each resid
within 1e-5 * ||b|| of its column, and the batches, rounds, convergence,
iterations and partials' iterations equal.  (A residual of 1e-4 * ||b||
is the difference of two f32 vectors of norm ||b||: its own relative
error is about 1e-7 * ||b|| / resid, so a relative bound on it would test
rounding.)  The reference's service tests (tests/test_serve.py) are also
rewritten for the port: the port's service against the port's own ``solve_batched`` on the same
``torch.Generator`` seed, bitwise.  The host-side pieces (buckets,
padding, the open-loop arrival plan, the percentile) are held bitwise
against the reference's.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.serve.service as port_service  # noqa: E402
from repro.core.engine import draw_picks as ref_draw_picks  # noqa: E402
from repro.serve import SolverService as RefSolverService  # noqa: E402
from repro.serve import bucket_rhs as ref_bucket_rhs  # noqa: E402
from repro.serve import loadgen as ref_loadgen  # noqa: E402
from repro.serve import pad_columns as ref_pad_columns  # noqa: E402
from repro_torch.core import random_sparse_spd  # noqa: E402
from repro_torch.core.engine import solve_batched  # noqa: E402
from repro_torch.core.operators import as_operator  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.serve import (SolverService, bucket_rhs,  # noqa: E402
                               loadgen, open_loop_load, pad_columns,
                               percentile, unpad_columns)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def prob():
    return random_sparse_spd(64, row_nnz=6, n_rhs=2, seed=0, device="cpu")


def _service(prob, **kw):
    kw.setdefault("num_iters", 2048)
    kw.setdefault("record_every", 64)
    svc = SolverService(**kw)
    svc.register("spd", prob.A, action="gs", format="csr", seed=0)
    return svc


def _solo(prob, b, tol, **kw):
    """The unpadded solo solve a served request must equal bitwise."""
    return solve_batched(as_operator(prob.A, "csr"), torch.as_tensor(b),
                         action="gs", num_iters=2048, record_every=64,
                         tol=tol, generator=torch.Generator().manual_seed(0),
                         **kw)


# -- host-side pieces against the reference -----------------------------------

def test_bucket_rhs_matches_reference():
    assert [bucket_rhs(k) for k in range(1, 201)] == \
        [ref_bucket_rhs(k) for k in range(1, 201)]
    for bad in (0, -3):
        with pytest.raises(ValueError, match="k must be > 0"):
            bucket_rhs(bad)
    assert bucket_rhs(5, buckets=(2, 4)) == 8


@pytest.mark.parametrize("k,kb", [(3, 4), (5, 8), (8, 8), (51, 64)])
def test_pad_and_unpad_match_reference(k, kb):
    b = np.random.default_rng(k).standard_normal((16, k)).astype(np.float32)
    got = pad_columns(torch.from_numpy(b), kb)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_pad_columns(jnp.asarray(b),
                                                             kb)))
    assert got.dtype == torch.float32 and got.shape == (16, kb)
    assert torch.equal(unpad_columns(got, k), torch.from_numpy(b))
    with pytest.raises(ValueError, match="cannot pad"):
        pad_columns(torch.from_numpy(b), k - 1)


def test_percentile_matches_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        vals = sorted(rng.standard_normal(n).tolist())
        for q in (0, 1, 50, 99, 100):
            assert percentile(vals, q) == ref_loadgen.percentile(vals, q)
    assert np.isnan(percentile([], 50))


class _FakeService:
    """Records what a load generator submits; answers at once."""

    def __init__(self, n):
        self._problems = {"p": SimpleNamespace(
            op=SimpleNamespace(shape=(n, n)))}
        self.seen = []

    def submit(self, name, b, *, rtol, deadline_s):
        self.seen.append((np.array(b), rtol, deadline_s))
        lat = 1e-3 * len(self.seen)
        return SimpleNamespace(result=lambda timeout=None: SimpleNamespace(
            latency_s=lat, converged=np.ones(1, bool),
            rounds=np.full(1, 3, np.int32)))


def test_open_loop_arrival_plan_matches_reference(monkeypatch):
    """The same seed gives bitwise the reference's gaps and RHS blocks."""
    runs = {}
    for tag, mod in (("port", loadgen), ("ref", ref_loadgen)):
        gaps = []
        monkeypatch.setattr(time, "sleep", gaps.append)
        svc = _FakeService(32)
        report = mod.open_loop_load(svc, "p", requests=12, rate_hz=50.0,
                                    rhs_widths=(1, 2, 4), rtol=1e-4, seed=5)
        runs[tag] = (gaps, svc.seen, report)
    (g1, s1, r1), (g2, s2, r2) = runs["port"], runs["ref"]
    assert g1 == g2 and len(g1) == 12
    assert len(s1) == len(s2)
    for (b1, rt1, d1), (b2, rt2, d2) in zip(s1, s2):
        assert b1.dtype == b2.dtype == np.float32
        np.testing.assert_array_equal(b1, b2)
        assert (rt1, d1) == (rt2, d2)
    assert {b.shape[1] for b, _, _ in s1} == {1, 2, 4}
    for f in ("requests", "p50_ms", "p99_ms", "mean_ms", "converged",
              "rounds_per_request", "latencies_ms"):
        assert getattr(r1, f) == getattr(r2, f), f


# -- the service against the reference's --------------------------------------

SERVE_ITERS, SERVE_REC, SERVE_SEED = 1024, 64, 7
# Each scenario is one batch: its requests are queued before the loop
# starts.  "tenants": widths 1, 2 and 3 (bucket 8).  "exits" (bucket 4): a
# loose and a tight tenant, one past its deadline at once, and one that
# never converges and runs to the iteration cap.
SCENARIOS = {
    "tenants": [(1, {}), (2, {}), (3, {})],
    "exits": [(1, dict(rtol=0.3)), (1, dict(rtol=1e-4)),
              (1, dict(rtol=1e-12, deadline_s=0.0)), (1, dict(rtol=1e-12))],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_service_matches_reference(prob, scenario, monkeypatch):
    """The port's service against the reference's on the same matrix, RHS
    blocks and rtol, the port's engine given the reference's stream."""
    ref = RefSolverService(num_iters=SERVE_ITERS, record_every=SERVE_REC)
    ref.register("spd", jnp.asarray(prob.A.numpy()), action="gs",
                 format="csr", seed=SERVE_SEED, rows_per_panel=8)
    port = SolverService(num_iters=SERVE_ITERS, record_every=SERVE_REC)
    port.register("spd", prob.A, action="gs", format="csr", seed=SERVE_SEED,
                  rows_per_panel=8)
    picks = torch.from_numpy(np.array(ref_draw_picks(
        ref._problems["spd"].op, "gs", jax.random.key(SERVE_SEED),
        SERVE_ITERS)))
    real = port_service.solve_batched

    def with_ref_stream(*args, generator, **kw):
        return real(*args, picks=picks, **kw)
    monkeypatch.setattr(port_service, "solve_batched", with_ref_stream)

    rng = np.random.default_rng(17)
    reqs = [(rng.standard_normal((64, w)).astype(np.float32), kw)
            for w, kw in SCENARIOS[scenario]]
    runs = {}
    for tag, svc in (("ref", ref), ("port", port)):
        tickets = [svc.submit("spd", b, **kw) for b, kw in reqs]
        with svc:
            results = [t.result(timeout=120) for t in tickets]
        runs[tag] = (svc.stats, tickets, results)
    (rs, rt, rr), (ps, pt, pr) = runs["ref"], runs["port"]

    for f in ("requests", "batches", "chunk_launches", "deadline_expired",
              "batch_widths"):
        assert getattr(ps, f) == getattr(rs, f), f
    assert ps.batches == 1
    for (b, _), want_t, got_t, want, got in zip(reqs, rt, pt, rr, pr):
        near = 1e-5 * np.linalg.norm(b, axis=0)
        assert got_t.request.tol.dtype == want_t.request.tol.dtype
        np.testing.assert_array_equal(got_t.request.tol,
                                      want_t.request.tol)
        assert (np.linalg.norm(got.x.numpy() - want.x)
                <= 1e-5 * np.linalg.norm(want.x))
        assert (np.abs(got.resid.numpy() - want.resid) <= near).all()
        np.testing.assert_array_equal(got.rounds.numpy(), want.rounds)
        np.testing.assert_array_equal(got.converged.numpy(), want.converged)
        assert got.iters_run == want.iters_run
        assert [p.iters for p in got_t.partials] == \
            [p.iters for p in want_t.partials]
        for gp, wp in zip(got_t.partials, want_t.partials):
            assert (np.abs(gp.resid.numpy() - wp.resid) <= near).all()
    if scenario == "exits":     # each exit really happened
        loose, tight, late, cap = rr
        assert loose.converged.all() and loose.rounds[0] < tight.rounds[0]
        assert not late.converged.any() and late.iters_run == SERVE_REC
        assert not cap.converged.any() and cap.iters_run == SERVE_ITERS
        assert rs.deadline_expired == 1
    else:
        assert all(r.converged.all() for r in rr)
        assert rs.batch_widths == [6]


# -- the continuous-batching service (the reference's seven behaviours) -------

def test_concurrent_tenants_share_one_batched_launch(prob):
    """Three tenants submitting concurrently land in one batch: one
    batched solve, and each tenant gets back exactly its own columns, on
    the host."""
    svc = _service(prob)
    rng = np.random.default_rng(3)
    widths = (1, 2, 3)
    blocks = [rng.standard_normal((64, w)).astype(np.float32)
              for w in widths]
    tickets = [None] * len(blocks)
    barrier = threading.Barrier(len(blocks))

    def tenant(i):
        barrier.wait()
        tickets[i] = svc.submit("spd", blocks[i], rtol=1e-3)

    threads = [threading.Thread(target=tenant, args=(i,))
               for i in range(len(blocks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # all three queued before the loop starts: one drain -> one batch
    with svc:
        results = [t.result(timeout=120) for t in tickets]

    assert svc.stats.batches == 1
    assert svc.stats.batch_widths == [sum(widths)]    # 6 -> bucket 8
    for w, blk, r in zip(widths, blocks, results):
        assert r.x.shape == (64, w) and r.x.device.type == "cpu"
        assert bool(r.converged.all())
        assert (r.resid.numpy()
                <= 1e-3 * np.linalg.norm(blk, axis=0)).all()

    # a later batch in the same bucket is a batch of its own
    with svc:
        t2 = svc.submit("spd", rng.standard_normal((64, 6)), rtol=1e-3)
        assert bool(t2.result(timeout=120).converged.all())
    assert svc.stats.batches == 2 and svc.stats.batch_widths == [6, 6]


@pytest.mark.parametrize("k", [3, 5])
def test_bucket_padding_bitwise_vs_unpadded_solo(prob, k):
    """A width-3 (5) request rides in a width-4 (8) bucket; its columns
    take bitwise the trajectory of an unpadded solo ``solve_batched`` on
    the same generator seed (zero padding is exact)."""
    b = np.random.default_rng(5).standard_normal((64, k)).astype(np.float32)
    tol = (1e-3 * np.linalg.norm(b, axis=0)).astype(np.float32)

    svc = _service(prob)
    with svc:
        served = svc.submit("spd", b, tol=tol).result(timeout=120)
    assert svc.stats.batch_widths == [k]
    assert bucket_rhs(k) > k                 # it really was padded

    solo = _solo(prob, b, tol)
    assert torch.equal(served.x, solo.x)
    assert torch.equal(served.resid, solo.resid)
    assert torch.equal(served.rounds, solo.rounds)
    # and the pad itself is inert: a padded run's real columns match too
    kb = bucket_rhs(k)
    padded = _solo(prob, pad_columns(torch.from_numpy(b), kb),
                   np.concatenate([tol, np.full(kb - k, np.inf, np.float32)]))
    assert torch.equal(padded.x[:, :k], solo.x)
    assert not padded.x[:, k:].any()


def test_per_request_tolerance_early_exit(prob):
    """A loose-tolerance tenant leaves its shared batch at an earlier
    record point than a tight-tolerance tenant; each result meets its own
    tolerance."""
    rng = np.random.default_rng(7)
    b1 = rng.standard_normal((64, 1)).astype(np.float32)
    b2 = rng.standard_normal((64, 1)).astype(np.float32)
    svc = _service(prob)
    t_loose = svc.submit("spd", b1, rtol=0.3)
    t_tight = svc.submit("spd", b2, rtol=1e-5)
    with svc:
        loose = t_loose.result(timeout=120)
        tight = t_tight.result(timeout=120)
    assert svc.stats.batches == 1             # they did share a batch
    assert bool(loose.converged.all()) and bool(tight.converged.all())
    assert int(loose.rounds.max()) < int(tight.rounds.max())
    assert float(loose.resid[0]) <= 0.3 * np.linalg.norm(b1)
    assert float(tight.resid[0]) <= 1e-5 * np.linalg.norm(b2)
    # the early leaver stopped receiving partials once it completed
    assert len(t_loose.partials) < len(t_tight.partials)


def test_deadline_completes_with_partial_iterate(prob):
    """A request past its deadline is completed at the next record point
    with its current partial iterate, marked unconverged."""
    b = np.random.default_rng(9).standard_normal((64, 1)).astype(np.float32)
    svc = _service(prob)
    with svc:
        # rtol far below the f32 floor: can never converge; deadline in the
        # past: expires at the first record point
        ticket = svc.submit("spd", b, rtol=1e-12, deadline_s=0.0)
        res = ticket.result(timeout=120)
    assert not bool(res.converged.any())
    assert res.iters_run == 64                # one record chunk, then out
    assert bool(torch.isfinite(res.resid).all())
    assert svc.stats.deadline_expired == 1


def test_streamed_partials_and_progress_callback(prob):
    """Partials stream at every record point the request is in flight at,
    increasing in iteration count, through both the ticket and the
    ``on_progress`` callback, with the bucket padding stripped."""
    b = np.random.default_rng(11).standard_normal((64, 2)).astype(np.float32)
    seen = []
    svc = _service(prob)
    with svc:
        ticket = svc.submit("spd", b, rtol=1e-4, on_progress=seen.append)
        res = ticket.result(timeout=120)
    assert bool(res.converged.all())
    assert ticket.partials == seen and len(seen) > 1
    iters = [p.iters for p in ticket.partials]
    assert iters == sorted(set(iters))
    for p in ticket.partials:
        assert p.x.shape == (64, 2) and p.x.device.type == "cpu"
        assert p.resid.shape == (2,)
    # partials precede the exit round; the final result is not a partial
    assert all(p.iters < res.iters_run for p in ticket.partials)


def test_open_loop_load_converges(prob):
    """The load generator end to end: mixed widths, all requests converge,
    latency and throughput populated."""
    svc = _service(prob, batch_window_s=0.005)
    with svc:
        report = open_loop_load(svc, "spd", requests=8, rate_hz=400.0,
                                rhs_widths=(1, 2, 4), rtol=1e-3, seed=0)
    assert report.converged == report.requests == 8
    assert svc.stats.requests == 8
    assert report.qps > 0 and np.isfinite(report.p50_ms)
    assert report.p50_ms <= report.p99_ms
    assert len(report.latencies_ms) == 8
    # batching happened: fewer batches than requests
    assert svc.stats.batches < 8


def test_submit_validates_shape_and_service_restarts(prob):
    svc = _service(prob)
    with pytest.raises(ValueError, match="expects"):
        svc.submit("spd", np.zeros((32, 1), np.float32))
    with pytest.raises(KeyError):
        svc.submit("nope", np.zeros((64, 1), np.float32))
    # start/stop twice: the loop thread is restartable
    for _ in range(2):
        with svc:
            t = svc.submit("spd", np.ones((64,), np.float32), rtol=1e-2)
            assert bool(t.result(timeout=120).converged.all())
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="already started"):
        svc.start()
        svc.start()
    svc.stop()


# -- the port's own service behaviours ----------------------------------------

def test_rk_request_bitwise_its_solo_solve():
    """A Kaczmarz problem served in a bucket equals its solo solve, on a
    b in A's range (a random b is not, and Kaczmarz's residual then stays
    near ||b||)."""
    from repro_torch.core import random_sparse_lsq
    lsq = random_sparse_lsq(128, 32, row_nnz=6, seed=2, device="cpu")
    svc = SolverService(num_iters=1024, record_every=64)
    svc.register("lsq", lsq.A, action="rk", format="csr", seed=4)
    x = np.random.default_rng(1).standard_normal((32, 3)).astype(np.float32)
    b = (lsq.A @ torch.from_numpy(x)).numpy()
    with svc:
        served = svc.submit("lsq", b, rtol=1e-2).result(timeout=120)
    solo = solve_batched(as_operator(lsq.A, "csr"), torch.from_numpy(b),
                         action="rk", num_iters=1024, record_every=64,
                         tol=(1e-2 * np.linalg.norm(b, axis=0)).astype(
                             np.float32),
                         generator=torch.Generator().manual_seed(4))
    assert served.x.shape == (32, 3) and bool(served.converged.all())
    assert torch.equal(served.x, solo.x)
    assert torch.equal(served.resid, solo.resid)
    assert torch.equal(served.rounds, solo.rounds)


def test_warmup_buckets_run_one_chunk_each(prob, monkeypatch):
    """``warmup_buckets`` runs one chunk per RHS bucket on the calling
    thread (widths 1, 3 and 64 -> buckets 1, 4 and 64) and serves
    nothing."""
    widths = []
    real = ops.sweep_rows_gs

    def spy(vals, cols, b, x, picks, **kw):
        widths.append(x.shape[1])
        return real(vals, cols, b, x, picks, **kw)
    monkeypatch.setattr(ops, "sweep_rows_gs", spy)
    svc = SolverService(num_iters=256, record_every=64)
    svc.register("spd", prob.A, action="gs", format="csr",
                 warmup_buckets=(1, 3, 64))
    assert widths == [1, 4, 64]
    assert svc.stats.batches == 0 and svc.stats.chunk_launches == 0
    with svc:
        svc.submit("spd", np.ones((64, 4), np.float32),
                   rtol=0.5).result(timeout=120)
    assert svc.stats.batches == 1
    assert widths[3:] == [4] * svc.stats.chunk_launches


def test_problems_keep_their_own_beta(prob):
    """Two problems of one shape, format and action but different
    relaxation ``beta`` each run with their own: each served request is
    bitwise its solo ``solve_batched`` at that beta, and the two differ."""
    b = np.random.default_rng(13).standard_normal((64, 2)).astype(np.float32)
    tol = (1e-3 * np.linalg.norm(b, axis=0)).astype(np.float32)
    svc = SolverService(num_iters=2048, record_every=64)
    for beta in (1.0, 0.5):
        svc.register(f"beta{beta}", prob.A, action="gs", format="csr",
                     seed=0, beta=beta, warmup_buckets=(2,))
    with svc:
        served = {beta: svc.submit(f"beta{beta}", b, tol=tol).result(
            timeout=120) for beta in (1.0, 0.5)}
    for beta, got in served.items():
        solo = _solo(prob, b, tol, beta=beta)
        assert torch.equal(got.x, solo.x), beta
        assert torch.equal(got.resid, solo.resid), beta
        assert got.rounds.tolist() == solo.rounds.tolist(), beta
    assert not torch.equal(served[1.0].x, served[0.5].x)


def test_batch_error_reaches_the_tickets(prob, monkeypatch):
    """An error on the service thread completes the batch's tickets with
    it; the loop goes on serving later batches."""
    svc = _service(prob)
    op = svc._problems["spd"].op
    real = op.gs_sweep

    def boom(*a, **kw):
        raise RuntimeError("sweep failed")
    monkeypatch.setattr(op, "gs_sweep", boom)
    with svc:
        t = svc.submit("spd", np.ones((64, 2), np.float32))
        with pytest.raises(RuntimeError, match="sweep failed"):
            t.result(timeout=120)
        monkeypatch.setattr(op, "gs_sweep", real)
        t2 = svc.submit("spd", np.ones((64, 1), np.float32), rtol=1e-2)
        assert bool(t2.result(timeout=120).converged.all())
    assert svc.stats.failed_batches == 1 and svc.stats.batches == 1


# -- the launcher -------------------------------------------------------------

def _launch(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"),
        capture_output=True, text=True, timeout=120)


def test_launch_serve_on_the_cpu():
    out = _launch("--device", "cpu", "--n", "64", "--requests", "8")
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 2
    assert "mode=batched requests=8 converged=8" in lines[0]
    assert "batches=" in lines[1] and "deadline_expired=0" in lines[1]


def test_launch_serve_rk_serial_on_the_cpu():
    # the launcher's random RHS is not in A's range: Kaczmarz's residual
    # stays near ||b||, so only a loose rtol is met
    out = _launch("--device", "cpu", "--n", "32", "--requests", "4",
                  "--action", "rk", "--serial", "--rtol", "2")
    assert out.returncode == 0, out.stderr
    assert "mode=serial requests=4 converged=4" in out.stdout
    assert "batches=4 " in out.stdout


def test_launch_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _launch("--n", "64", "--requests", "2")
    assert out.returncode != 0 and "[serve]" not in out.stdout


# -- the lazy build under threads ---------------------------------------------

def test_library_builds_and_loads_once_from_many_threads(monkeypatch,
                                                         tmp_path):
    """Eight threads reaching a kernel first at once build every source
    once and load the library once (no nvcc needed: the compile step is
    a stand-in that writes its output file)."""
    compiled, loaded = [], []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.out = Path(cmd[cmd.index("-o") + 1])
            compiled.append(cmd[-1])
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)            # widen the window for a race
            self.out.write_bytes(b"")
            return "", None

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or path)
    monkeypatch.setattr(_build, "_loaded", {})
    got = [None] * 8
    barrier = threading.Barrier(8)

    def user(i):
        barrier.wait()
        got[i] = _build.library("colsum")

    threads = [threading.Thread(target=user, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(Path(c).stem for c in compiled) == sorted(_build.SOURCES)
    assert len(loaded) == 1 and len(set(got)) == 1
    assert Path(got[0]).name.startswith("colsum-")
