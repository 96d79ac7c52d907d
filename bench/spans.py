"""The program's own spans in a traced run, reduced beside ``trace.py``'s
fields: host time, card-idle time and stream operations by span.

The port marks its engine's phases while a profiler records
(``repro_torch/spans.py``: ``RecordFunction`` ranges named
``repro_torch.<phase>``, CPU events on the unit thread, on the clock of the
card's operations).  ``from_profiler`` gives ``trace.from_profiler``'s
``Trace``, its fields computed by that function untouched, with five more,
from the unit thread's program spans clipped to the traced window:

* ``program_s``: host seconds by span name;
* ``program_n``: spans by name;
* ``program_self_s``: host seconds by innermost program span (a span's
  time less its child spans');
* ``program_idle_s``: card-idle seconds by innermost program span, each
  idle gap intersected exactly with the spans' intervals;
* ``program_stream_ops``: by span name, the host's runtime calls that put
  work on a stream (``STREAM_CALLS``) made inside it.

A program without spans (one older than them) gives empty fields, and the
readers of ``METRICS`` then read nothing.  ``run_cell`` runs a cell as
``run.py --trace 1`` does, with this reduction in place of
``trace.from_profiler`` and ``METRICS`` among the cell's per-layer metrics;
``run_spans.py`` is its command line.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

from bench import harness, registry
from bench import trace as trace_mod

#: the name every program span starts with (``repro_torch.spans.PREFIX``)
PREFIX = "repro_torch."
#: the outermost span of a unit: the program's ``solve_batched`` call
SOLVE = PREFIX + "solve_batched"

#: ``trace.py``'s reduction, whatever later takes its name
_BASE = trace_mod.from_profiler

#: runtime and driver calls by which the host puts work on a stream
STREAM_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaMemcpyAsync", "cudaMemsetAsync"})

#: the cells of each suffix and the end-to-end metric they report
_SUFFIXES = {"solve": ("rhs_per_s", ["spd16k-gs-solve"]),
             "block": ("rhs_per_s.block", ["spd16k-bgs128-solve"]),
             "sweep": ("sweep_ms", ["hpcg104-gs-sweep",
                                    "hpcg104-bgs8-sweep"])}
_FAMILIES = {"host_us_per_record": ("us", "engine"),
             "engine_idle_us_per_record": ("us", "device"),
             "stream_ops_per_record": ("operations", "dispatch seam")}

#: the ``per_layer`` entries of the span families (``metrics/<family>.py``)
METRICS = [dict(name=f"{family}.{suffix}", unit=unit, better="lower",
                source="program_span", layer=layer, moves=moves,
                workloads=list(cells))
           for family, (unit, layer) in _FAMILIES.items()
           for suffix, (moves, cells) in _SUFFIXES.items()]


@dataclass
class SpanTrace(trace_mod.Trace):
    program_s: dict = field(default_factory=dict)           # span -> s
    program_n: dict = field(default_factory=dict)           # span -> count
    program_self_s: dict = field(default_factory=dict)      # innermost -> s
    program_idle_s: dict = field(default_factory=dict)      # innermost -> s
    program_stream_ops: dict = field(default_factory=dict)  # span -> calls


def from_profiler(prof) -> SpanTrace | None:
    """``trace.from_profiler(prof)`` with the program's fields; None when
    the trace holds no unit span."""
    base = _BASE(prof)
    if base is None:
        return None
    return SpanTrace(**vars(base),
                     **program(prof.profiler.kineto_results.events()))


def program(events) -> dict:
    """The program fields of ``SpanTrace`` from the profiler's raw
    events, over the window and on the thread ``trace.py`` takes."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    units, host, device = [], [], []
    for e in events:
        kind, name = e.device_type(), e.name()
        if kind == cpu:
            if name == trace_mod.UNIT_SPAN:
                units.append((e.start_ns(), e.end_ns(), e.start_thread_id()))
            elif name.startswith(PREFIX) or name in STREAM_CALLS:
                host.append((e.start_ns(), e.end_ns(), name,
                             e.start_thread_id()))
        elif kind == cuda and not e.is_user_annotation() \
                and not name.startswith(("bench.", PREFIX)):
            device.append((e.start_ns(), e.end_ns()))
    if not units:
        return {}
    lo, hi = min(u[0] for u in units), max(u[1] for u in units)
    thread = units[0][2]
    busy = trace_mod._merge((max(s, lo), min(e, hi)) for s, e in device
                            if min(e, hi) > max(s, lo))
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans, calls = [], []
    for s, e, name, tid in host:
        if tid != thread:
            continue
        if name in STREAM_CALLS:
            if lo <= s < hi:
                calls.append(s)
        elif min(e, hi) > max(s, lo):
            spans.append((max(s, lo), min(e, hi), name))
    spans.sort(key=lambda h: (h[0], -h[1]))
    calls.sort()
    by_name = defaultdict(list)
    for s, e, name in spans:
        by_name[name].append((s, e))
    pieces = innermost(spans)
    self_s = defaultdict(float)
    for s, e, name in pieces:
        self_s[name] += (e - s) * 1e-9
    return dict(
        program_s={name: sum(e - s for s, e in trace_mod._merge(iv)) * 1e-9
                   for name, iv in by_name.items()},
        program_n={name: len(iv) for name, iv in by_name.items()},
        program_self_s=dict(self_s),
        program_idle_s=_overlap(pieces, gaps),
        program_stream_ops=_counts(spans, calls))


def innermost(spans) -> list:
    """Nested spans ``(start, end, name)``, sorted by start and longest
    first, cut into disjoint pieces, each named by the innermost span open
    over it."""
    out, stack, pos = [], [], None

    def close(t):
        nonlocal pos
        while stack and stack[-1][1] <= t:
            _, e, name = stack.pop()
            if e > pos:
                out.append((pos, e, name))
                pos = e

    for s, e, name in spans:
        close(s)
        if stack and s > pos:
            out.append((pos, s, stack[-1][2]))
        stack.append((s, e, name))
        pos = s if pos is None else max(pos, s)
    close(float("inf"))
    return out


def _overlap(pieces, gaps) -> dict:
    """Seconds of ``gaps`` inside each named piece (both sorted, each
    disjoint)."""
    out = defaultdict(float)
    i = j = 0
    while i < len(pieces) and j < len(gaps):
        s, e, name = pieces[i]
        a, b = gaps[j]
        if min(e, b) > max(s, a):
            out[name] += (min(e, b) - max(s, a)) * 1e-9
        if e <= b:
            i += 1
        else:
            j += 1
    return dict(out)


def _counts(spans, calls) -> dict:
    """For each span name, the ``calls`` (sorted start times) made while a
    span of that name was open."""
    out = defaultdict(int)
    stack, i = [], 0
    for t in calls:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        for name in {name for _, _, name in stack}:
            out[name] += 1
    return dict(out)


def per_record(t: SpanTrace) -> dict:
    """Each program field over the traced records (the ``engine.record``
    spans), and the share of ``solve_batched``'s host time that the spans
    inside it cover."""
    records = t.program_n.get(PREFIX + "engine.record", 0)
    if not records:
        return {}
    top = t.program_s.get(SOLVE, 0.0)

    def scale(d):
        return {k: v / records for k, v in sorted(d.items())}

    return dict(records=records,
                host_us=scale({k: 1e6 * v for k, v in t.program_s.items()}),
                self_us=scale({k: 1e6 * v
                               for k, v in t.program_self_s.items()}),
                idle_us=scale({k: 1e6 * v
                               for k, v in t.program_idle_s.items()}),
                stream_ops=scale(t.program_stream_ops),
                spans=dict(sorted(t.program_n.items())),
                coverage=(1.0 - t.program_self_s.get(SOLVE, 0.0) / top
                          if top > 0 else None))


def run_cell(workload: str, seed: int, seconds: float, **kw) -> dict:
    """``harness.run_cell(..., trace=True)`` with ``from_profiler`` in
    place of ``trace.from_profiler`` and the ``METRICS`` that list the cell
    among its per-layer metrics; the result gains ``program``
    (``per_record``) before its last key, ``checks``."""
    saved = trace_mod.from_profiler, registry.cell_metrics
    kept = []

    def reduce(prof):
        kept.append(from_profiler(prof))
        return kept[-1]

    def cell_metrics(name, group, root=registry.ROOT):
        found = saved[1](name, group, root)
        if group != "per_layer":
            return found
        return found + [m for m in METRICS if name in m["workloads"]]

    trace_mod.from_profiler, registry.cell_metrics = reduce, cell_metrics
    try:
        result = harness.run_cell(workload, seed, seconds, True, **kw)
    finally:
        trace_mod.from_profiler, registry.cell_metrics = saved
    checks = result.pop("checks")
    result["program"] = per_record(kept[0]) if kept and kept[0] else {}
    result["checks"] = checks
    return result
