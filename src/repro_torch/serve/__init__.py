"""Solver-as-a-service: the persistent serving layer over ``core.engine``
(port of ``repro/serve``).

``SolverService`` wraps the engine's chunked batched entry
(``solve_batched``) behind a thread-safe request queue: concurrent
tenants' RHS columns are batched onto the engine's multi-RHS axis, padded
to shape buckets, solved with per-column tolerances on the operator's
device, and un-padded on exit, with per-request deadlines, early exit at
record points and streamed partial iterates on the host.
"""
from repro_torch.serve.bucketing import (RHS_BUCKETS, bucket_rhs, pad_columns,
                                         unpad_columns)
from repro_torch.serve.loadgen import LoadReport, open_loop_load, percentile
from repro_torch.serve.queue import (Partial, Request, RequestQueue,
                                     RequestResult, Ticket)
from repro_torch.serve.service import (RegisteredProblem, ServiceStats,
                                       SolverService)

__all__ = [
    "LoadReport",
    "Partial",
    "RHS_BUCKETS",
    "RegisteredProblem",
    "Request",
    "RequestQueue",
    "RequestResult",
    "ServiceStats",
    "SolverService",
    "Ticket",
    "bucket_rhs",
    "open_loop_load",
    "pad_columns",
    "percentile",
    "unpad_columns",
]
