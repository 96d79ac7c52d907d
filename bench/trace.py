"""The device trace of a traced run, reduced to what the metrics read.

``torch.profiler`` records the card's operations (kernels, copies, sets)
and the host's spans and operator calls.  From its raw events this keeps:
the traced window (from the first ``bench.unit`` span's start to the last
one's end), the seconds in which some operation ran on the card, the
card's time by operation, and each idle gap of the card named by what the
host was doing at its middle: the harness's innermost ``bench.*`` span and
the innermost operator call inside it (``python`` where there is none).
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

UNIT_SPAN = "bench.unit"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list: ``gs_kernel<float, int, true>``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].strip()


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)     # short name -> seconds
    gaps_s: dict = field(default_factory=dict)       # host activity -> seconds
    events: int = 0                                  # device operations

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose short name matches the
        regular expression ``pattern`` (``re.search``)."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_s.items() if rx.search(name))

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(self.device_s), "idle_gaps": head(self.gaps_s)}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_names(host, times):
    """For each time (sorted), the innermost ``bench.*`` span open then and
    the innermost other call open inside it."""
    stack, out, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            s, e, name = host[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        span, call = "none", "python"
        for _, _, name in stack:
            if name.startswith("bench."):
                span, call = name, "python"
            else:
                call = name
        out.append(f"{span}/{call}")
    return out


def from_profiler(prof) -> Trace | None:
    """The reduced trace of a stopped ``torch.profiler.profile``; None
    when it holds no unit span."""
    events = prof.profiler.kineto_results.events()
    units, host, device = [], [], []
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for e in events:
        kind = e.device_type()
        if kind == cpu:
            if e.name() == UNIT_SPAN:
                units.append((e.start_ns(), e.end_ns(), e.start_thread_id()))
            host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
        elif kind == cuda and not e.is_user_annotation() \
                and not e.name().startswith("bench."):
            device.append((e.start_ns(), e.end_ns(), e.name()))
    if not units:
        return None
    lo, hi = min(u[0] for u in units), max(u[1] for u in units)
    thread = units[0][2]
    device_s = defaultdict(float)
    spans = []
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            device_s[short_name(name)] += (e - s) * 1e-9
            spans.append((s, e))
    busy = _merge(spans)
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = sorted(((s, e, name) for s, e, name, tid in host if tid == thread),
                  key=lambda h: (h[0], -h[1]))
    gaps_s = defaultdict(float)
    mids = [(a + b) // 2 for a, b in gaps]
    for (a, b), name in zip(gaps, _host_names(host, mids)):
        gaps_s[name] += (b - a) * 1e-9
    return Trace(window_s=(hi - lo) * 1e-9,
                 busy_s=sum(e - s for s, e in busy) * 1e-9,
                 device_s=dict(device_s), gaps_s=dict(gaps_s),
                 events=len(spans))
