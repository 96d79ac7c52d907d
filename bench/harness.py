"""Run one cell of ``BENCHMARK.json`` once.

Set-up builds the configuration's matrix from its generator, packs it into
the panel layout, hands the arrays to the program's public constructor
``repro_torch.convert.csr_from_arrays`` (rows a panel: the program's own
choice, as ``repro_torch.solve`` makes it) and touches the operator's
padded views.  It then runs one unit of the cell's traffic (a solve or a
sweep, drawn apart from the window's) so that every kernel the window
runs is built and warm.  The window runs units through
``repro_torch.solve_batched`` back to back until ``seconds`` have passed,
and ends at the first unit boundary after that.

Once the window has closed and the peak memory is read, the operator is
freed, the reference rebuilds the matrix from the configuration and
replays a sample of the window's units (``reference/compare.py``): the
unit that ran the most records (a solve cell) or the first sweep (a sweep
cell), and a reservoir sample drawn from the seed.
"""
from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from bench import registry
from bench import trace as trace_mod
from bench.problem import packed_layout
from bench.reference import compare, gs
from bench.traffic import Done, Driver

#: Top-level module names that may not be loaded once the window closes:
#: JAX and the JAX package (the port's own name begins with it, so names
#: are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: Units a run checks besides the one its rule picks, drawn from the seed.
CHECK_UNITS = 2


class SetupClock:
    """Marks on the host clock from the script's first line to the window:
    each phase of set-up is the time from the mark before it."""

    def __init__(self, t_start: float | None = None):
        self.marks = [("start", time.perf_counter() if t_start is None
                       else t_start)]

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))

    def phases(self) -> list[tuple[str, float]]:
        return [(name, t - before) for (_, before), (name, t)
                in zip(self.marks, self.marks[1:])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: dict
    config: dict
    traffic: dict
    driver: Driver
    device_name: str
    setup_s: float
    build_s: float
    window_s: float
    units: list[Done]
    launches: dict
    trace: trace_mod.Trace | None
    row_nnz: torch.Tensor          # (n,) int64: stored nonzeros a row
    nnz: int
    _stats: list | None = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.driver.n

    def sweeps(self) -> int:
        return sum(u.records for u in self.units)

    def record_stats(self) -> list[dict]:
        """For each record of each traced unit: its picks, the distinct
        directions (rows or panels) among them and their stored nonzeros,
        and the stored nonzeros of the picked directions pick by pick."""
        if self._stats is None:
            d = self.driver
            per_dir = self.row_nnz.view(d.directions, d.block).sum(1)
            out = []
            for u in self.units:
                if not u.traced:
                    continue
                picks = d.draw(u.index)[2][:u.records * d.per_record].long()
                picks = picks.view(u.records, d.per_record)
                seen = torch.zeros((u.records, d.directions), dtype=torch.bool,
                                   device=picks.device)
                seen.scatter_(1, picks, True)
                distinct = seen.sum(1).tolist()
                distinct_nnz = (seen.long() * per_dir).sum(1).tolist()
                stream_nnz = per_dir[picks].sum(1).tolist()
                out += [dict(picks=d.per_record, distinct=a, distinct_nnz=b,
                             stream_nnz=c)
                        for a, b, c in zip(distinct, distinct_nnz, stream_nnz)]
            self._stats = out
        return self._stats


class Keep:
    """The units the reference will check: one chosen by rule (the solve
    that ran the most records, or the first sweep) and a reservoir sample
    of ``size`` drawn from the seed (Algorithm R), whatever the window's
    length."""

    def __init__(self, kind: str, size: int, seed: int):
        self.kind, self.size = kind, size
        self.rng = np.random.default_rng([seed % 2 ** 64, 1])
        self.rule = None
        self.pool: list = []
        self.seen = 0

    def offer(self, item) -> None:
        index, res, _ = item
        if self.kind == "solve":
            if self.rule is None or res.iters_run > self.rule[1].iters_run:
                self.rule = item
        elif index == 0:
            self.rule = item
        if self.seen < self.size:
            self.pool.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.pool[j] = item
        self.seen += 1

    def items(self) -> list:
        out = {}
        for item in [self.rule, *self.pool]:
            if item is not None:
                out.setdefault(item[0], item)
        return [out[i] for i in sorted(out)]


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    """The card's name and power limit by ``nvidia-smi``, for the log."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root=registry.ROOT, device="cuda", clock: SetupClock | None = None,
             log=None) -> dict:
    """Run cell ``workload`` once; returns the result line's object (its
    last key, ``checks``, holds each compared number beside its limit).
    ``clock`` holds set-up's marks so far (the script's first line on)."""
    clock = clock or SetupClock()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = registry.cell(workload, root)
    config = registry.config(cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root)
    limits = registry.cell_data(workload, root)["limits"]
    from repro_torch.kernels import ops

    op, driver, row_nnz, nnz, build_s = setup(config, traffic, seed, device,
                                              root, clock)

    solve_unit(op, driver, -1, driver.start())       # warm-up
    clock.mark("warm_up")
    keep = Keep(driver.kind, CHECK_UNITS, seed)
    ops.reset_launch_counts()
    units, t_window, window_s, prof = run_window(op, driver, seconds, keep,
                                                 trace=trace)
    clock.marks.append(("to_window", t_window))
    setup_s = t_window - clock.marks[0][1]
    log("setup: " + ", ".join(f"{name} {s:.3f} s" for name, s in clock.phases())
        + f"; setup_s {setup_s:.3f} s")
    launches = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced = trace_mod.from_profiler(prof) if trace else None
    del op, prof
    checked = keep.items()
    keep = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings = reference_check(config, root, device, driver, checked)
    correct, table = compare.verdict(readings, limits)
    del checked
    log(f"reference: {readings.units} units in "
        f"{time.perf_counter() - t_ref:.3f} s: {readings.detail}")

    run = Run(cell, config, traffic, driver, card(device)["kind"], setup_s,
              build_s, window_s, units, launches, traced, row_nnz, nnz)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(workload, group, root):
        value = registry.reader(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(card(device), memory_peak_bytes=int(peak))
    result = {"correct": bool(correct), "attempted": len(units),
              "failed": sum(u.failed for u in units), "metrics": metrics,
              "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
        log(f"trace: {traced.events} device operations in "
            f"{traced.window_s:.3f} s")
    if device.type == "cuda":
        log(f"card: {power_limit()}")
    result["checks"] = table
    return result


def setup(config: dict, traffic: dict, seed: int, device: torch.device,
          root=registry.ROOT, clock: SetupClock | None = None):
    """Build the configuration's operator the way a user of the port
    would: its matrix from the generator, packed by the harness, handed to
    ``csr_from_arrays`` with the program's own rows a panel, its padded
    views touched.  Returns (op, driver, row_nnz, nnz, build_s)."""
    clock = clock or SetupClock()
    from repro_torch.convert import csr_from_arrays
    from repro_torch.tune import runtime
    clock.mark("import_port")

    torch.backends.cuda.matmul.allow_tf32 = False
    generate = registry.generator(config["generator"], root).generate
    with record_function("bench.generate"):
        problem = generate(config, device)
        _sync(device)
        clock.mark("generate")
        layout = packed_layout(problem,
                               runtime.tuned_rows_per_panel(problem.n) or 8)
    row_nnz, nnz = problem.row_nnz(), problem.nnz
    driver = Driver(traffic, problem.n, problem.b, seed, device)
    del problem
    _sync(device)
    clock.mark("pack")
    t0 = time.perf_counter()
    with record_function("bench.build"):
        op = csr_from_arrays(**layout, device=device)
        op.padded_rows()
        op.sliced_rows()
        op.panel_nnz()
        _sync(device)
    clock.mark("build")
    return op, driver, row_nnz, nnz, time.perf_counter() - t0


def solve_unit(op, driver: Driver, index: int, x_in):
    """Unit ``index`` of the driver's traffic: one ``solve_batched`` call
    from ``x_in`` (None: zeros), synchronised."""
    from repro_torch import solve_batched

    with record_function("bench.draw"):
        b, tol, picks = driver.draw(index)
    with record_function("bench.solve_batched"):
        res = solve_batched(op, b, x_in, action="gs",
                            num_iters=driver.num_iters, tol=tol, picks=picks,
                            record_every=driver.per_record,
                            block=driver.block)
        _sync(b.device)
    return res


def run_window(op, driver: Driver, seconds: float, keep: Keep, *,
               trace: bool = False):
    """Units back to back until ``seconds`` have passed, ending at the
    first unit boundary after that; each unit is offered to ``keep``.  In
    a traced run the profiler records the first ``trace_units`` units.
    Returns (units, the window's start on the host clock, its length, the
    stopped profiler or None)."""
    carry = driver.kind == "sweep"
    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if op.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    tracing = trace
    units: list[Done] = []
    resids = []
    x = driver.start()
    t_window = time.perf_counter()
    due, index = t_window, 0
    while True:
        x_in = x if carry else None
        if tracing:
            with record_function(trace_mod.UNIT_SPAN):
                res = solve_unit(op, driver, index, x_in)
        else:
            res = solve_unit(op, driver, index, x_in)
        done = time.perf_counter()
        records = res.iters_run // driver.per_record
        converged = int(res.converged.sum())
        units.append(Done(index, due, done, records, converged,
                          driver.kind == "solve" and converged < driver.k,
                          tracing))
        keep.offer((index, res, x_in))
        if carry:
            x = res.x
            resids.append(res.resid)
        index += 1
        over = done - t_window >= seconds
        if tracing and (over or index == driver.trace_units):
            prof.stop()
            tracing = False
        if over:
            break
        due = done
    if carry:
        bad = (~torch.isfinite(torch.stack(resids))).any(1).tolist()
        for u, b in zip(units, bad):
            u.failed = bool(b)
    return units, t_window, done - t_window, prof


def reference_check(config: dict, root, device, driver: Driver,
                    items) -> compare.Readings:
    """Rebuild the matrix from the configuration and replay each kept unit
    ``(index, result, x_in)`` on the reference."""
    generate = registry.generator(config["generator"], root).generate
    problem = generate(config, device)
    A = gs.Matrix(problem.indptr, problem.indices, problem.data)
    del problem
    units = []
    for index, res, x_in in items:
        b, tol, picks = driver.draw(index)
        units.append(compare.Unit(
            b=b, tol=tol, picks=picks[:res.iters_run],
            x_in=torch.zeros_like(res.x) if x_in is None else x_in,
            x=res.x, resid=res.resid, rounds=res.rounds,
            converged=res.converged, iters_run=res.iters_run,
            per_record=driver.per_record, cap_records=driver.cap_records,
            block=driver.block))
    return compare.check(A, units)


def p95(values) -> float:
    """The 95th percentile by nearest rank: an observed value."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]
