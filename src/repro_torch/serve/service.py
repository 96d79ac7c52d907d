"""The persistent solver service (port of ``repro/serve/service.py``):
continuous batching of concurrent tenants' RHS columns onto the engine's
multi-RHS axis.

Independent in-flight requests share the iterate machinery the way the
paper's independent workers share the iterate.  Columns of a batched solve
are independent under both engine actions, so packing N tenants' RHS
columns into one ``(n, k)`` block and running one chunked solve gives
every tenant bitwise the trajectory of a solo solve, at one chunk's
launches per record point (on a CSR operator on the card: the sweep, the
matvec and ``colsum``) instead of N.

Per batch: drain the queue (admission window ``batch_window_s``), group by
registered problem, concatenate columns on the operator's device, pad to
the RHS bucket (``serve.bucketing``) and drive
``core.engine.solve_batched`` with the problem's action and ``beta`` and
per-column tolerances.  The reference keeps a cache of compiled chunk
executors keyed by shape; the port compiles nothing per shape (its kernels
are built once per process), so it has none.  At every record point the
service streams partial iterates to in-flight tickets, completes tenants
whose columns converged (a loose-tolerance tenant leaves early while the
batch goes on for the others) and enforces per-request deadlines (a tenant past its deadline
gets its partial iterate, marked unconverged).  Joins happen at batch
boundaries and leaves at record points.

What a tenant gets back (``RequestResult``, ``Partial``) lies on the host.
The service thread launches the kernels on its own current stream (the
default stream unless the caller set one).  An error in a batch completes
that batch's open tickets with it: ``Ticket.result()`` raises it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.engine import (draw_picks, resolve_record_every,
                                     sequential_chunk, solve_batched)
from repro_torch.core.operators import as_operator
from repro_torch.serve.bucketing import bucket_rhs, pad_columns, unpad_columns
from repro_torch.serve.queue import (Partial, Request, RequestQueue,
                                     RequestResult, Ticket)


@dataclass
class RegisteredProblem:
    """A named operator tenants can submit RHS against."""

    name: str
    op: object
    action: str
    format: str
    storage_dtype: str | None
    #: seed of the pick stream, fixed per problem: each batch draws from a
    #: fresh ``torch.Generator(op.device).manual_seed(seed)`` (the
    #: reference holds a ``jax.random`` key; the streams differ)
    seed: int
    beta: float
    num_iters: int
    record_every: int

    def generator(self) -> torch.Generator:
        return torch.Generator(self.op.device).manual_seed(self.seed)


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    chunk_launches: int = 0
    deadline_expired: int = 0
    #: batches that raised (their tickets got the error)
    failed_batches: int = 0
    #: per-batch RHS widths (real columns, before bucket padding)
    batch_widths: list = field(default_factory=list)
    #: per-batch wall seconds on the host's clock, from the batch's
    #: concatenation to its last ticket (the admission window excluded)
    batch_seconds: list = field(default_factory=list)
    #: per-batch record chunks run
    batch_chunks: list = field(default_factory=list)


class SolverService:
    """A persistent solver wrapping ``solve_batched`` behind a queue.

    Use as a context manager (``with SolverService(...) as svc``) or call
    ``start()`` / ``stop()`` explicitly.  ``max_batch`` caps how many
    requests one batch admits; ``batch_window_s`` is how long the loop
    lingers after the first arrival so concurrent tenants share a launch.
    The reference's ``fused=`` is gone: the port has one engine.
    """

    def __init__(self, *, num_iters: int = 4096, record_every: int = 64,
                 max_batch: int = 32, batch_window_s: float = 0.002):
        resolve_record_every(num_iters, record_every)  # fail fast, once
        self.num_iters = num_iters
        self.record_every = record_every
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.stats = ServiceStats()
        self._queue = RequestQueue()
        self._problems: dict[str, RegisteredProblem] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- registration -------------------------------------------------------

    def register(self, name: str, A, *, action: str = "gs",
                 format: str = "dense", storage_dtype=None, seed: int = 0,
                 beta: float = 1.0, num_iters: int | None = None,
                 record_every: int | None = None, warmup_buckets=(),
                 **op_kwargs) -> RegisteredProblem:
        """Register the dense tensor ``A`` under ``name``: its operator is
        built once, on A's device, and kept warm.

        The pick stream derives from ``seed`` alone, so every batch
        against this problem replays the same direction stream: a tenant's
        result depends only on its RHS and its tolerance, not on the
        batch it landed in.  ``warmup_buckets`` runs one chunk per RHS
        bucket and draws one stream, on the calling thread, so that the
        kernels' build and the first launches stay out of the first
        batch's latency.
        """
        num_iters = self.num_iters if num_iters is None else num_iters
        record_every = (self.record_every if record_every is None
                        else record_every)
        resolve_record_every(num_iters, record_every)
        op = as_operator(A, format, storage_dtype=storage_dtype, **op_kwargs)
        reg = RegisteredProblem(
            name=name, op=op, action=action, format=format,
            storage_dtype=storage_dtype, seed=seed, beta=beta,
            num_iters=num_iters, record_every=record_every)
        self._problems[name] = reg
        rn = op.row_norms_sq() if action == "rk" else None
        n_x = op.shape[0] if action == "gs" else op.shape[1]
        for kb in warmup_buckets:
            kb = bucket_rhs(kb)
            picks = torch.zeros((record_every,), dtype=torch.int32,
                                device=op.device)
            sequential_chunk(
                op, torch.zeros((op.shape[0], kb), device=op.device),
                torch.zeros((n_x, kb), device=op.device), picks,
                action=action, beta=beta, rn=rn)
        if warmup_buckets:
            draw_picks(op, action, num_iters, generator=reg.generator())
            if op.device.type == "cuda":
                torch.cuda.synchronize(op.device)
        return reg

    # -- submission ---------------------------------------------------------

    def submit(self, name: str, b, *, tol=None, rtol: float | None = None,
               deadline_s: float | None = None,
               on_progress=None) -> Ticket:
        """Enqueue RHS ``b`` (``(n,)`` or ``(n, c)``) against ``name``.

        ``b`` goes to the operator's device as f32.  ``tol`` is an
        absolute per-column residual target (scalar or ``(c,)``);
        ``rtol`` instead scales each column's ``||b||_2`` (default
        ``rtol=1e-3`` when neither is given), computed as the reference
        does, by numpy on the host copy of the f32 block.  ``deadline_s``
        is a relative wall-clock budget: a request past its deadline is
        completed with its current partial iterate, ``converged=False``.
        """
        reg = self._problems[name]
        b = torch.as_tensor(b, dtype=torch.float32, device=reg.op.device)
        if b.ndim == 1:
            b = b[:, None]
        if b.shape[0] != reg.op.shape[0]:
            raise ValueError(
                f"RHS has {b.shape[0]} rows; problem {name!r} expects "
                f"{reg.op.shape[0]}")
        if tol is None:
            rtol = 1e-3 if rtol is None else rtol
            tol = rtol * np.linalg.norm(b.cpu().numpy(), axis=0)
        tol = np.broadcast_to(
            np.asarray(tol, np.float32), (b.shape[1],)).copy()
        deadline = (None if deadline_s is None
                    else time.monotonic() + deadline_s)
        req = Request(problem=name, b=b, tol=tol, deadline=deadline,
                      on_progress=on_progress)
        return self._queue.submit(req)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "SolverService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="solver-service", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "SolverService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._queue.drain(self.max_batch, wait_s=0.05,
                                      window_s=self.batch_window_s)
            if not batch:
                continue
            by_problem: dict[str, list] = {}
            for pair in batch:
                by_problem.setdefault(pair[0].problem, []).append(pair)
            for name, items in by_problem.items():
                self._execute(self._problems[name], items)

    # -- batch execution ----------------------------------------------------

    def _execute(self, reg: RegisteredProblem, items: list) -> None:
        """One continuous batch: concat -> pad -> chunked solve -> unpad.
        An error completes every ticket still open with it."""
        done = [False] * len(items)
        t0 = time.perf_counter()
        try:
            self._solve(reg, items, done)
            self.stats.batch_seconds.append(time.perf_counter() - t0)
        except Exception as e:     # handed to the tenants, never dropped
            self.stats.failed_batches += 1
            for i, (_, ticket) in enumerate(items):
                if not done[i]:
                    ticket.fail(e)

    def _solve(self, reg: RegisteredProblem, items: list, done: list) -> None:
        rec = reg.record_every
        spans, cols, tols = [], [], []
        start = 0
        for req, _ in items:
            c = req.b.shape[1]
            spans.append(slice(start, start + c))
            cols.append(req.b)
            tols.append(req.tol)
            start += c
        k = start
        kb = bucket_rhs(k)
        B = pad_columns(torch.cat(cols, dim=1), kb)
        # Padded columns get +inf tolerance: their residual is exactly 0
        # (zero column, zero iterate), so they never gate the early exit.
        tol_full = np.full((kb,), np.inf, np.float32)
        tol_full[:k] = np.concatenate(tols)

        first_chunk = torch.zeros((kb,), dtype=torch.int32)

        def finish(i, x_host, resid_host, conv_cols, chunks_done):
            req, ticket = items[i]
            s = spans[i]
            rounds = torch.where(first_chunk[s] > 0, first_chunk[s],
                                 chunks_done).to(torch.int32)
            done[i] = True
            # The request's columns lie inside the real [0, k) region of
            # the bucket, so its span's slice is the unpad.
            ticket.complete(RequestResult(
                x=x_host[:, s].clone(), resid=resid_host[s].clone(),
                rounds=rounds, converged=conv_cols.clone(),
                iters_run=chunks_done * rec,
                latency_s=time.monotonic() - req.submitted))

        def on_record(ci, x, resid, conv):
            self.stats.chunk_launches += 1
            newly = conv & (first_chunk == 0)
            first_chunk[newly] = ci + 1
            now = time.monotonic()
            x_host = resid_host = None
            for i, (req, ticket) in enumerate(items):
                if done[i]:
                    continue
                if x_host is None:
                    # the real columns only: the bucket's padding is zero
                    x_host = unpad_columns(x, k).cpu()
                    resid_host = resid.cpu()
                s = spans[i]
                conv_cols = conv[s]
                expired = req.deadline is not None and now >= req.deadline
                if bool(conv_cols.all()) or expired:
                    if expired and not bool(conv_cols.all()):
                        self.stats.deadline_expired += 1
                    finish(i, x_host, resid_host, conv_cols, ci + 1)
                else:
                    ticket.push_partial(Partial(
                        iters=(ci + 1) * rec, x=x_host[:, s].clone(),
                        resid=resid_host[s].clone()))
            return not all(done)

        res = solve_batched(
            reg.op, B, action=reg.action, generator=reg.generator(),
            num_iters=reg.num_iters, record_every=rec, tol=tol_full,
            beta=reg.beta, on_record=on_record)

        # Anyone still open hit the iteration cap: complete with finals.
        if not all(done):
            x_host = unpad_columns(res.x, k).cpu()
            resid_host = res.resid.cpu()
            chunks_done = res.iters_run // rec
            for i in range(len(items)):
                if not done[i]:
                    finish(i, x_host, resid_host, res.converged[spans[i]],
                           chunks_done)

        self.stats.requests += len(items)
        self.stats.batches += 1
        self.stats.batch_widths.append(k)
        self.stats.batch_chunks.append(res.iters_run // rec)
