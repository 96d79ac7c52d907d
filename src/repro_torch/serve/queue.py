"""Thread-safe request queue and completion tickets (port of
``repro/serve/queue.py``; pure host code).

Tenants call ``SolverService.submit`` from arbitrary threads; the service
loop drains pending requests in arrival order and batches them onto the
engine's multi-RHS axis.  A ``Ticket`` is the caller's handle: it blocks
on ``result()``, and receives streamed partial iterates (one per record
point the request was still in flight at) via ``partials`` /
``on_progress``.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

_ids = itertools.count()


@dataclass
class Request:
    """One tenant's solve ask against a registered problem."""

    problem: str            # registered problem name
    b: object               # (n, c) f32 RHS block (c >= 1 columns)
    tol: object             # (c,) f32 absolute residual target per column
    deadline: float | None  # absolute time.monotonic() cutoff, or None
    submitted: float = field(default_factory=time.monotonic)
    on_progress: Callable | None = None
    id: int = field(default_factory=lambda: next(_ids))


class Partial(NamedTuple):
    """A streamed in-flight snapshot at a record point."""

    iters: int     # iterations executed when the snapshot was taken
    x: object      # (n, c) partial iterate on the host (padding stripped)
    resid: object  # (c,) current residual per column, on the host


class RequestResult(NamedTuple):
    x: object             # (n, c) final iterate of the request's columns
    resid: object         # (c,) final residual per column
    rounds: object        # (c,) int32 record chunks each column needed
    converged: object     # (c,) bool per column (all four on the host)
    iters_run: int        # iterations this request's batch executed for it
    latency_s: float      # submit -> completion wall time


class Ticket:
    """Completion handle handed back by ``submit``."""

    def __init__(self, request: Request):
        self.request = request
        self.partials: list[Partial] = []
        self._event = threading.Event()
        self._result: RequestResult | None = None
        self._error: BaseException | None = None

    def push_partial(self, partial: Partial) -> None:
        self.partials.append(partial)
        if self.request.on_progress is not None:
            self.request.on_progress(partial)

    def complete(self, result: RequestResult) -> None:
        self._result = result
        self._event.set()

    def fail(self, error: BaseException) -> None:
        """Complete with ``error``: ``result()`` raises it (a batch that
        failed on the service thread never leaves its tenants waiting)."""
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> RequestResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not complete within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class RequestQueue:
    """FIFO of ``(Request, Ticket)`` pairs with a batching drain."""

    def __init__(self):
        self._cv = threading.Condition()
        self._items: deque = deque()

    def submit(self, request: Request) -> Ticket:
        ticket = Ticket(request)
        with self._cv:
            self._items.append((request, ticket))
            self._cv.notify_all()
        return ticket

    def drain(self, max_requests: int, *, wait_s: float = 0.05,
              window_s: float = 0.0) -> list:
        """Up to ``max_requests`` pending pairs, in arrival order.

        Blocks up to ``wait_s`` for the first arrival; once something is
        pending, waits a further ``window_s`` so concurrent tenants land
        in the same batch (the continuous-batching admission window).
        """
        with self._cv:
            if not self._items:
                self._cv.wait(wait_s)
            if not self._items:
                return []
        if window_s > 0:
            time.sleep(window_s)
        with self._cv:
            out = []
            while self._items and len(out) < max_requests:
                out.append(self._items.popleft())
            return out

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)
