"""The engine's host spans (``repro_torch.spans``) under ``torch.profiler``.

A solve under a profiler gives one ``repro_torch.solve_batched`` span with
one ``engine.picks`` inside it and one each of ``engine.sweep``,
``engine.record``, ``engine.wait`` and ``engine.exit`` a record; with no
profiler no ``RecordFunction`` is built; and the results are bitwise equal
with and without one, for coordinate and block GS.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.core import random_sparse_spd  # noqa: E402
from repro_torch.core.engine import solve_batched  # noqa: E402
from repro_torch.core.operators import as_operator  # noqa: E402

N, K, SWEEPS = 64, 3, 6
CHILDREN = ("engine.sweep", "engine.record", "engine.wait", "engine.exit")


def _problem():
    p = random_sparse_spd(N, row_nnz=6, n_rhs=K, seed=3, device="cpu")
    return as_operator(p.A, "csr", rows_per_panel=8), p.b


def _solve(block, *, picks=True, tol=0.0):
    op, b = _problem()
    per = N // block
    g = torch.Generator().manual_seed(5)
    stream = torch.randint(0, per, (SWEEPS * per,), generator=g)
    kw = dict(picks=stream) if picks else dict(
        generator=torch.Generator().manual_seed(5))
    return solve_batched(op, b, action="gs", num_iters=SWEEPS * per, tol=tol,
                         record_every=per, block=block, beta=0.9, **kw)


def _spans(prof):
    """(start, end, name without the prefix) of the program's spans."""
    out = [(e.start_ns(), e.end_ns(), e.name().removeprefix(spans.PREFIX))
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(spans.PREFIX)]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def _profiled(fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, _spans(prof)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("picks", [True, False], ids=["picks", "generator"])
def test_spans_nest_once_a_record(picks):
    res, got = _profiled(lambda: _solve(1, picks=picks))
    records = res.iters_run // N
    assert records == SWEEPS
    top = [s for s in got if s[2] == "solve_batched"]
    assert len(top) == 1
    top = top[0]
    assert all(_inside(s, top) for s in got)
    picks_spans = [s for s in got if s[2] == "engine.picks"]
    assert len(picks_spans) == 1
    # the given stream's range read is the one wait inside engine.picks
    in_picks = [s for s in got if s is not picks_spans[0]
                and _inside(s, picks_spans[0])]
    assert [s[2] for s in in_picks] == (["engine.wait"] if picks else [])
    per_record = [s for s in got if s[2] in CHILDREN and s not in in_picks]
    for name in CHILDREN:
        assert sum(s[2] == name for s in per_record) == records, name
    # one record after another: sweep, record, wait, exit, none inside
    # another
    assert [s[2] for s in per_record] == list(CHILDREN) * records
    for a, b in zip(per_record, per_record[1:]):
        assert a[1] <= b[0]


def test_spans_follow_the_early_exit():
    res, got = _profiled(lambda: _solve(1, tol=1e30))
    assert res.iters_run == N
    assert [s[2] for s in got] == ["solve_batched", "engine.picks",
                                   "engine.wait", *CHILDREN]


def test_no_record_function_without_a_profiler(monkeypatch):
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    _solve(1)
    _solve(8)
    assert made == []
    _profiled(lambda: _solve(8))
    assert "repro_torch.solve_batched" in made
    assert all(name.startswith(spans.PREFIX) for name in made)


def test_span_is_a_shared_no_op_without_a_profiler():
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        pass


@pytest.mark.parametrize("block", [1, 8], ids=["gs", "block_gs"])
def test_profiler_leaves_results_bitwise(block):
    plain = _solve(block, tol=0.5)
    traced, got = _profiled(lambda: _solve(block, tol=0.5))
    assert got, "no span recorded under the profiler"
    assert torch.equal(plain.x, traced.x)
    assert torch.equal(plain.resid, traced.resid)
    assert torch.equal(plain.rounds, traced.rounds)
    assert torch.equal(plain.converged, traced.converged)
    assert plain.iters_run == traced.iters_run
