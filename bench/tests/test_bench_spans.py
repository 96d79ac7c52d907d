"""The reduction of the program's spans (``bench/spans.py``) on synthetic
event lists, and the span families on the CPU at a small size.

On the lists: a card-idle gap that straddles two spans is split exactly
between them; the runtime calls that put work on a stream count only
inside program spans on the unit thread; ``trace.py``'s fields read as
``trace.from_profiler`` gives them.  On the CPU: a traced run with the
spans reduced reports ``host_us_per_record`` in every cell beside every
per-layer metric a traced run reports, and with ``trace.py``'s reduction
alone the span families read nothing and raise nothing.
"""
import json
from dataclasses import asdict

import pytest
import torch

from bench import harness, spans
from bench import trace as trace_mod
from bench.tests.tiny import make_root

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
P = spans.PREFIX
CELLS = ["spd16k-gs-solve", "hpcg104-gs-sweep", "spd16k-bgs128-solve",
         "hpcg104-bgs8-sweep"]


class Event:
    def __init__(self, name, start, end, kind=CPU, tid=1, annotation=False):
        self._v = (name, start, end, kind, tid, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class Prof:
    """What the reductions read of a stopped ``torch.profiler.profile``."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda _: events})()
        self.profiler = type("Profile", (), {"kineto_results": results})()


def events():
    """One unit [0, 1000] ns on thread 1: ``solve_batched`` [100, 900] with
    a sweep [150, 300], a record [300, 500], a wait [500, 700] and an exit
    [700, 850]; kernels at [200, 400] and [650, 950]; so the gaps are
    [0, 200], [400, 650] (record 100 ns, wait 150 ns) and [950, 1000]."""
    return [
        Event(trace_mod.UNIT_SPAN, 0, 1000, annotation=True),
        Event("bench.solve_batched", 50, 980, annotation=True),
        Event(P + "solve_batched", 100, 900),
        Event(P + "engine.sweep", 150, 300),
        Event(P + "engine.record", 300, 500),
        Event(P + "engine.wait", 500, 700),
        Event(P + "engine.exit", 700, 850),
        Event("aten::sub", 310, 330),
        Event("cudaLaunchKernel", 160, 170),          # sweep
        Event("cudaLaunchKernel", 320, 325),          # record
        Event("cudaMemcpyAsync", 510, 520),           # wait
        Event("cudaLaunchKernel", 60, 70),            # harness: outside
        Event("cudaLaunchKernel", 320, 330, tid=2),   # another thread
        Event(P + "engine.sweep", 150, 300, tid=2),   # another thread
        Event("cudaStreamSynchronize", 530, 690),     # no stream work
        Event("gs_kernel<float>(int)", 200, 400, CUDA, tid=7),
        Event("rw_kernel<float>(int)", 650, 950, CUDA, tid=7),
        Event("bench.solve_batched", 200, 960, CUDA, tid=7, annotation=True),
    ]


def test_gap_split_exactly_between_spans():
    t = spans.from_profiler(Prof(events()))
    ns = {k: round(v * 1e9) for k, v in t.program_idle_s.items()}
    # [400, 650]: 100 ns in the record, 150 in the wait; of [0, 200],
    # [100, 150] in solve_batched alone and [150, 200] in the sweep;
    # [950, 1000] outside solve_batched
    assert ns == {P + "engine.record": 100, P + "engine.wait": 150,
                  P + "solve_batched": 50, P + "engine.sweep": 50}
    # by the gap's middle (525) trace.py names it all after the wait
    assert t.gaps_s["bench.solve_batched/" + P + "engine.wait"] == \
        pytest.approx(250e-9)


def test_host_time_by_span_and_innermost():
    t = spans.from_profiler(Prof(events()))
    ns = {k: round(v * 1e9) for k, v in t.program_s.items()}
    assert ns == {P + "solve_batched": 800, P + "engine.sweep": 150,
                  P + "engine.record": 200, P + "engine.wait": 200,
                  P + "engine.exit": 150}
    self_ns = {k: round(v * 1e9) for k, v in t.program_self_s.items()}
    assert self_ns[P + "solve_batched"] == 100        # [100,150] + [850,900]
    assert self_ns[P + "engine.record"] == 200
    assert t.program_n[P + "engine.sweep"] == 1


def test_stream_calls_counted_inside_spans_on_the_unit_thread():
    t = spans.from_profiler(Prof(events()))
    assert t.program_stream_ops == {P + "solve_batched": 3,
                                    P + "engine.sweep": 1,
                                    P + "engine.record": 1,
                                    P + "engine.wait": 1}


def test_nested_spans_cut_into_innermost_pieces():
    got = spans.innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"),
                           (6, 8, "d"), (12, 14, "e")])
    assert got == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                   (6, 8, "d"), (8, 10, "a"), (12, 14, "e")]


@pytest.mark.parametrize("case", ["spans", "no_spans", "no_unit"])
def test_trace_fields_as_trace_py_gives_them(case):
    evs = events()
    if case == "no_spans":
        evs = [e for e in evs if not e.name().startswith(P)]
    elif case == "no_unit":
        evs = [e for e in evs if e.name() != trace_mod.UNIT_SPAN]
    base = trace_mod.from_profiler(Prof(evs))
    got = spans.from_profiler(Prof(evs))
    if base is None:
        assert got is None
        return
    fields = asdict(got)
    for name, value in asdict(base).items():
        assert fields[name] == value, name
    assert got.breakdown() == base.breakdown()
    if case == "no_spans":
        assert not got.program_s and not got.program_stream_ops
        assert not got.program_idle_s


def test_metrics_read_the_fields():
    t = spans.from_profiler(Prof(events()))
    unit = harness.Done(0, 0.0, 1.0, 2, 0, False, True)
    run = type("Run", (), {"trace": t, "units": [unit]})()
    from bench import registry

    def read(name):
        return registry.reader(name).read(run)

    assert read("host_us_per_record.block") == pytest.approx((800 - 200)
                                                             * 1e-3 / 2)
    assert read("engine_idle_us_per_record.block") == pytest.approx(
        350 * 1e-3 / 2)
    assert read("stream_ops_per_record.block") == 1.5
    # a trace from trace.py alone, or none: nothing, and no error
    for trace in (trace_mod.from_profiler(Prof(events())), None):
        run.trace = trace
        for family in ("host_us_per_record", "engine_idle_us_per_record",
                       "stream_ops_per_record"):
            assert read(family + ".solve") is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, fn):
    return fn(cell, 2 ** 31 + 23, 0.05, root=root, device="cpu",
              log=lambda _: None)


@pytest.mark.parametrize("cell", CELLS)
def test_span_families_on_the_cpu(root, cell):
    plain = _run(root, cell, lambda *a, **kw: harness.run_cell(
        a[0], a[1], a[2], True, **kw))
    got = _run(root, cell, spans.run_cell)
    assert got["correct"] and plain["correct"]
    suffix = {"spd16k-gs-solve": "solve", "spd16k-bgs128-solve": "block"}.get(
        cell, "sweep")
    names = set(got["metrics"])
    assert set(plain["metrics"]) <= names
    assert f"host_us_per_record.{suffix}" in names
    assert got["metrics"][f"host_us_per_record.{suffix}"]["value"] > 0
    # the CPU trace holds no card operation: the card's readings are absent
    assert not any(n.startswith(("engine_idle_us_per_record",
                                 "stream_ops_per_record")) for n in names)
    program = got["program"]
    assert program["records"] >= 1
    assert program["spans"][P + "solve_batched"] >= 1
    assert 0.0 < program["coverage"] <= 1.0
    assert list(got)[-2:] == ["program", "checks"]


def test_families_listed_read_nothing_without_the_reduction(root, tmp_path):
    """A ``BENCHMARK.json`` listing the families, run with ``trace.py``'s
    reduction alone (a harness not yet wired to the spans): the families
    are left out of the line, every other metric is there."""
    bm = json.loads((root / "BENCHMARK.json").read_text())
    before = _run(root, "spd16k-bgs128-solve", lambda *a, **kw:
                  harness.run_cell(a[0], a[1], a[2], True, **kw))
    bm["per_layer"] += spans.METRICS
    listed = make_root(tmp_path)
    (listed / "BENCHMARK.json").write_text(json.dumps(bm))
    got = _run(listed, "spd16k-bgs128-solve", lambda *a, **kw:
               harness.run_cell(a[0], a[1], a[2], True, **kw))
    assert got["correct"]
    assert set(got["metrics"]) == set(before["metrics"])
