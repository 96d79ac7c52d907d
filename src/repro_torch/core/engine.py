"""The solver engine's schedules, result types and front door (port of
the sequential part of ``repro/core/engine.py``; the distributed engine is
``core/distributed.py``).

Two actions over one pick stream:

* ``"gs"`` — randomized coordinate Gauss-Seidel (the paper's Alg. 1) on a
  unit-diagonal SPD system, coordinates drawn uniformly;
* ``"rk"`` — randomized Kaczmarz (Sec. 7), rows drawn with probability
  proportional to ``||A_i||^2``.

Each record chunk is one sweep call on the operator (``op.gs_sweep`` /
``op.rk_sweep``): on a CSR, ELL or block-banded operator on the card that
is one launch of its sweep kernel, on the CPU its plain version; a dense
operator has no coordinate-sweep kernel and steps through its picks in
plain PyTorch.  On the block-banded format a GS pick is a whole block row
(``op.nb`` directions); it has no sequential Kaczmarz action (the banded
Kaczmarz runs in the distributed engine).  Block GS (``gs_block`` > 1,
the paper's Alg. 1 at the TPU's block granularity, ``DESIGN.md`` §2) on
the dense or the CSR format picks aligned panels of ``gs_block`` rows
(``n // gs_block`` directions) and runs each chunk as one
``op.block_gs_sweep`` launch (dense: the block-GS kernel; CSR: the block
mode of the GS sweep over the row windows).  ELL and the block-banded
format refuse ``gs_block`` > 1, as the reference does.

Picks are drawn with a ``torch.Generator``: a different stream from the
reference's ``jax.random`` threefry key.  ``picks=`` overrides the drawn
stream, which is how the tests feed both packages the same directions.

A ``Schedule`` with ``rounds``/``local_steps`` runs the distributed
engine on a ``torch.distributed`` process group (``solve(..., group=)``).
A ``Schedule`` with ``tau > 0`` runs ``solve_async_sim``, the bounded-delay
simulator of the paper's Secs. 4 and 6: plain PyTorch (the reference's is a
``jnp`` scan with no Pallas kernel), a few launches a step, with the pick
and delay streams read to the host once per solve so that no step waits
for the card.  Its delays come from ``delay_generator=`` (a different
stream from the reference's ``delay_key``) or from ``delays=``.

The serving unit is ``sequential_chunk`` (one record chunk: the sweep and
the residual) and ``solve_batched`` (chunks with per-column tolerances and
early exit), which ``serve/`` drives.  While a ``torch.profiler`` records,
they mark their host phases with ``repro_torch.spans.span``:
``solve_batched``, and inside it ``engine.picks`` (the stream's checks),
``engine.sweep``, ``engine.record``, ``engine.wait`` (each blocking read to
the host) and ``engine.exit`` (the tolerance test).

A distributed ``Schedule`` also carries the slab assignment
(``partition``), the overlapped sync (``overlap``) and the wire codec
(``compress``); ``PARTITIONS``, ``COMPRESS_MODES`` and ``supported_syncs``
are the vocabularies every validation error and CLI ``choices=`` read.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.operators import (BlockBandedOp, CsrOp, DenseOp,
                                        as_operator)
from repro_torch.kernels import ops
from repro_torch.spans import span
from repro_torch.tune import runtime as tune_runtime


#: distributed slab assignments understood by ``Schedule.partition``
PARTITIONS = ("contiguous", "balanced")

#: wire codecs understood by ``Schedule.compress`` (int8 blocks with error
#: feedback, round-to-nearest bf16; "none" is the exact f32 wire)
COMPRESS_MODES = ("none", "bf16", "int8_ef")


def supported_syncs(action, formats=None):
    """Sync modes the distributed engine's strategy table has a row for,
    for ``action``; ``formats`` (operator class names) narrows the answer
    to the formats a caller can build (the CLIs' ``choices=``)."""
    from repro_torch.core.distributed import _DISTRIBUTED_STRATEGIES
    return tuple(sorted({
        s for (a, f, s) in _DISTRIBUTED_STRATEGIES
        if a == action and (formats is None or f in formats)}))


def _warn_overlap_fallback(op, action, kind):
    warnings.warn(
        f"overlap=True: the {kind!r} strategy (action={action!r} x "
        f"{type(op).__name__}) has no overlapped-sync variant; running "
        "lockstep rounds (exact fallback — iterates unchanged)",
        UserWarning, stacklevel=3)


def _warn_compress_fallback(op, action, kind, compress):
    warnings.warn(
        f"compress={compress!r}: the {kind!r} strategy (action={action!r} x "
        f"{type(op).__name__}) has no compressed wire format; running the "
        "f32 payload (exact fallback — iterates unchanged)",
        UserWarning, stacklevel=3)


class SolveResult(NamedTuple):
    x: torch.Tensor        # (n, k) final iterate
    err_sq: torch.Tensor   # (records, k) squared error at each record point
    resid: torch.Tensor    # (records, k) ||b - A x||_2 at each record point
    iters: torch.Tensor    # (records,) iteration index of each record


class ParallelSolveResult(NamedTuple):
    x: torch.Tensor        # (n, k) the assembled iterate, the same on
                           # every rank (RK where P does not divide n:
                           # the calling rank's replica)
    err_sq: torch.Tensor   # (rounds, k)
    resid: torch.Tensor    # (rounds, k)
    tau: int               # effective staleness bound of the schedule
    #: per-round measured exchange lag (overlap=True only, else None),
    #: (rounds,) int32: lag[r] = max over ranks of the foreign updates
    #: committed by the end of round r-1 that the rank's round-r reads do
    #: NOT see.  The empirical staleness of a run is ``max(lag) +
    #: scheduled_tau(...)`` with ``overlap=False``, which the schedule
    #: keeps <= ``scheduled_tau(..., overlap=True)`` == ``tau``.
    lag: torch.Tensor | None = None
    #: analytic per-round wire volume: bytes one rank contributes to the
    #: sync collective each round under the dispatched strategy, sync and
    #: codec (averaged over the ranks for the a2a exchanges; 0 at P = 1,
    #: where none runs).
    bytes_per_round: float | None = None


def scheduled_tau(num_workers: int, local_steps: int, *,
                  shared_stream: bool = False,
                  local_sampling: bool = False,
                  overlap: bool = False) -> int:
    """Staleness bound of the periodic-synchronization schedule.

    ``shared_stream=False`` (per-worker direction streams, the RGS scheme):
    a worker's read can miss every other worker's in-round updates, so
    tau = (P - 1) * local_steps — the paper's Thm 4.1(a) bound.

    ``shared_stream=True`` (one global i.i.d. pick stream partitioned by
    owner, the RK scheme): within a round a pick misses at most the other
    workers' *earlier* in-round updates, so tau = local_steps - 1 (and 0 at
    P = 1, where every pick is owned and nothing is ever stale).

    ``local_sampling=True`` (per-worker local sampling, the sparse-RK
    scheme): every worker's ``local_steps`` picks are useful updates, so
    the round's interleaved shared stream carries P * local_steps picks
    and the shared-stream bound applies to that length —
    tau = P * local_steps - 1.

    ``overlap=True`` (double-buffered sync): round r's exchange is issued
    concurrently with round r+1's local sweep, so a worker's reads
    additionally miss the *previous round's* foreign updates — the bound
    grows by exactly that payload:

    * per-worker streams: the other P-1 workers' full previous round,
      + (P - 1) * local_steps;
    * shared stream: the whole previous round of the stream,
      + local_steps;
    * local sampling: the other workers' previous-round picks,
      + (P - 1) * local_steps.

    At P = 1 there is nothing in flight and the term is 0.
    """
    extra = 0
    if overlap and num_workers > 1:
        if local_sampling or not shared_stream:
            extra = (num_workers - 1) * local_steps
        else:
            extra = local_steps
    if local_sampling:
        shared_stream = True
        local_steps = num_workers * local_steps
    if shared_stream:
        return extra + (0 if num_workers == 1 else local_steps - 1)
    return extra + (num_workers - 1) * local_steps


class Schedule(NamedTuple):
    """Execution plan for ``solve``: exactly one of three modes.

    * sequential:  ``num_iters`` > 0 steps, recorded every
      ``record_every`` steps (``0``: once, at the end);
    * bounded-delay simulator: the same with ``tau`` > 0, every read up
      to ``tau`` updates stale (``solve_async_sim``);
    * distributed: ``rounds`` > 0 rounds of ``local_steps`` > 0 local
      updates each, a sync and a record after every round (needs a
      process group).

    Distributed only: ``partition`` picks the slab assignment
    (``"contiguous"``, rows in index order, or ``"balanced"``, the
    norm/nnz-balanced row permutation of ``core.partition``, CSR and ELL
    only); ``overlap`` double-buffers the sync (round r's exchange carries
    the payload captured at the end of round r-1, so reads are one round
    staler and tau grows by ``scheduled_tau``'s overlap term; strategies
    without an overlapped variant run lockstep rounds with a warning);
    ``compress`` is the wire format of the sync payload (``"none"``,
    ``"bf16"``, ``"int8_ef"``; strategies without a compressed wire run
    the f32 payload with a warning).
    """
    num_iters: int = 0
    rounds: int = 0
    local_steps: int = 0
    tau: int = 0
    record_every: int = 0
    partition: str = "contiguous"
    overlap: bool = False
    compress: str = "none"

    @property
    def distributed(self) -> bool:
        return self.rounds > 0

    def validate(self) -> "Schedule":
        """Reject ambiguous mode mixtures with a message naming the fields
        (the reference's checks on these fields)."""
        if self.distributed and (self.num_iters > 0 or self.tau > 0):
            raise ValueError(
                "ambiguous Schedule: rounds/local_steps (distributed) "
                "cannot be combined with num_iters/tau (sequential / async "
                f"simulator) — got {self}")
        if self.distributed and self.local_steps <= 0:
            raise ValueError(
                f"a distributed Schedule needs local_steps > 0 (got {self})")
        if self.tau < 0:
            raise ValueError(f"tau must be >= 0 (got {self})")
        if self.partition not in PARTITIONS:
            raise ValueError(
                f"unknown partition: {self.partition!r} (expected one of "
                f"{PARTITIONS})")
        if self.compress not in COMPRESS_MODES:
            raise ValueError(
                f"unknown compress: {self.compress!r} (expected one of "
                f"{COMPRESS_MODES})")
        if not self.distributed:
            if self.num_iters <= 0:
                raise ValueError(
                    "a sequential/async Schedule needs num_iters > 0 "
                    f"(got {self})")
            if self.local_steps > 0:
                raise ValueError(
                    "local_steps without rounds is ambiguous — set rounds > 0 "
                    f"for distributed execution (got {self})")
            if self.partition != "contiguous":
                raise ValueError(
                    "partition='balanced' is a distributed-schedule option "
                    f"(slab assignment needs rounds/local_steps) — got {self}")
            if self.overlap:
                raise ValueError(
                    "overlap=True is a distributed-schedule option (the "
                    "double-buffered sync needs rounds/local_steps) — got "
                    f"{self}")
            if self.compress != "none":
                raise ValueError(
                    "compress is a distributed-schedule option (there is no "
                    "sync payload to compress without rounds/local_steps) — "
                    f"got {self}")
        return self

    def effective_tau(self, num_workers: int, *, shared_stream: bool = False,
                      local_sampling: bool = False) -> int:
        if self.distributed:
            return scheduled_tau(num_workers, self.local_steps,
                                 shared_stream=shared_stream,
                                 local_sampling=local_sampling,
                                 overlap=self.overlap)
        return self.tau


def record_metrics(op, b, x, x_star, *, norm: str):
    """(err_sq, resid) per RHS column.

    ``norm="A"``: ||x - x*||_A^2; ``norm="euclid"``: ||x - x*||_2^2.
    ``resid`` is always ||b - A x||_2.  ``x_star=None`` yields NaN
    ``err_sq`` and the finite residual.

    A·x goes through ``op.matvec``: the CSR matvec kernel on the card, its
    plain version on the CPU.  (The reference calls its jnp segment sum,
    ``matvec_ref``, here; the two compute the same function.)  The column
    sums go through ``ops.colsum``, whose order does not depend on the
    column count, so a zero-padded RHS column leaves the others' records
    bitwise unchanged.
    """
    if norm not in ("A", "euclid"):
        raise ValueError(norm)
    if x_star is None:
        err = torch.full((x.shape[1],), math.nan, dtype=torch.float32,
                         device=x.device)
    else:
        e = x - x_star
        err = ops.colsum(e * (op.matvec(e) if norm == "A" else e))
    r = b - op.matvec(x)
    return err, torch.sqrt(ops.colsum(r * r))


def resolve_record_every(num_iters: int, record_every: int) -> int:
    """The effective record-chunk length; ``0`` means "record once, at the
    end"."""
    rec = record_every or num_iters
    if num_iters % rec != 0:
        raise ValueError(
            f"num_iters ({num_iters}) must be divisible by record_every "
            f"({rec})")
    return rec


def sample_rows(rn: torch.Tensor, num: int, *,
                generator: torch.Generator) -> torch.Tensor:
    """``num`` i.i.d. row indices with P(i) ∝ rn_i (zero rows never picked).

    Inverse-CDF sampling: uniform draws of ``generator`` scaled to the total
    weight, located in the cumulative weights by ``searchsorted``.  The
    cumulative weights are summed on the host in f64, in row order, so the
    stream is the same from run to run on the card too (``torch.multinomial``
    sums its CDF with ``torch.cumsum``, whose CUDA kernel adds in no fixed
    order).  All-zero ``rn`` samples uniformly instead, as the reference
    defines it.
    """
    if not bool((rn > 0).any()):
        return torch.randint(0, rn.shape[0], (num,), generator=generator,
                             device=rn.device)
    cdf = rn.detach().to("cpu", torch.float64).cumsum(0).to(rn.device)
    u = torch.rand(num, generator=generator, dtype=torch.float64,
                   device=rn.device) * cdf[-1]
    # below the total, so a draw never lands past the last positive row
    u = torch.minimum(u, torch.nextafter(cdf[-1], cdf.new_zeros(())))
    return torch.searchsorted(cdf, u, right=True)


def num_directions(op, action: str, block: int = 1) -> int:
    """How many directions a pick chooses from: block rows for GS on the
    block-banded format, aligned panels of ``block`` rows for block GS
    (``block > 1``), rows otherwise."""
    if action == "gs" and isinstance(op, BlockBandedOp):
        return op.nb
    if action == "gs" and block > 1:
        return op.shape[0] // block
    return op.shape[0]


def draw_picks(op, action: str, num_iters: int, *,
               generator: torch.Generator, block: int = 1) -> torch.Tensor:
    """The sequential engine's direction stream: GS directions (coordinates,
    block rows of a block-banded operator, or aligned panels of ``block``
    rows) uniform, RK rows ∝ ||A_i||^2."""
    if action == "gs":
        return torch.randint(0, num_directions(op, action, block),
                             (num_iters,), generator=generator,
                             device=op.device)
    if action == "rk":
        return sample_rows(op.row_norms_sq(), num_iters, generator=generator)
    raise ValueError(f"unknown action: {action!r}")


def direction_stream(op, action: str, num_iters: int, *,
                     generator: torch.Generator | None,
                     picks: torch.Tensor | None,
                     block: int = 1) -> torch.Tensor:
    """The checked direction stream of a sequential solve, as contiguous
    int32 on the operator's device, so that each chunk's slice reaches the
    sweep wrappers without a copy.

    Checks ``action``, ``block`` and the format against each other, then
    draws ``num_iters`` picks from ``generator`` or checks the given
    ``picks`` (shape, and every id in range: one read of the stream's
    minimum and maximum, once per solve).
    """
    if action not in ("gs", "rk"):
        raise ValueError(f"unknown action: {action!r}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if block > 1 and action != "gs":
        raise ValueError(
            f"block={block} is a Gauss-Seidel granularity; the Kaczmarz "
            "action steps row by row (block=1)")
    if block > 1 and not isinstance(op, (DenseOp, CsrOp)):
        raise NotImplementedError(
            f"block GS with block={block} needs aligned row panels (the "
            f"dense or CSR format; got {type(op).__name__}); the block-banded "
            "format steps its own block rows (block=, with gs_block=1)")
    if action == "rk" and isinstance(op, BlockBandedOp):
        raise NotImplementedError(
            "sequential RK needs per-row access (dense, ELL or CSR); the "
            "banded Kaczmarz action belongs to the distributed engine "
            "(Schedule(rounds=..., local_steps=...) with a group)")
    if picks is None:
        if generator is None:
            raise ValueError("a sequential solve needs a generator or picks")
        picks = draw_picks(op, action, num_iters, generator=generator,
                           block=block)
    else:
        picks = torch.as_tensor(picks, device=op.device)
        if picks.shape != (num_iters,):
            raise ValueError(f"picks has shape {tuple(picks.shape)}, "
                             f"expected ({num_iters},)")
        with span("engine.wait"):
            lo, hi = (int(v) for v in torch.aminmax(picks))
        top = num_directions(op, action, block)
        if lo < 0 or hi >= top:
            raise IndexError(f"pick ids span [{lo}, {hi}], allowed "
                             f"[0, {top})")
    return picks.to(torch.int32).contiguous()


def sweep(op, b, x, picks, *, action: str, beta: float, block: int, rn):
    """One record chunk's steps: one ``op.gs_sweep`` / ``op.rk_sweep``
    call (``rn`` the Kaczmarz divisor), or with ``block > 1`` (block GS,
    dense or CSR) one ``op.block_gs_sweep`` call."""
    if block > 1:
        return op.block_gs_sweep(b, x, picks, block=block, beta=beta)
    if action == "gs":
        return op.gs_sweep(b, x, picks, beta=beta)
    if action == "rk":
        return op.rk_sweep(b, rn, x, picks, beta=beta)
    raise ValueError(f"unknown action: {action!r}")


def solve_sequential(
    op,
    b: torch.Tensor,
    x0: torch.Tensor,
    x_star: torch.Tensor | None,
    *,
    action: str,
    num_iters: int,
    generator: torch.Generator | None = None,
    picks: torch.Tensor | None = None,
    beta: float = 1.0,
    block: int = 1,
    record_every: int = 0,
) -> SolveResult:
    """Sequential randomized solve: one local-update step per iteration.

    The direction stream is ``picks`` when given (``num_iters`` direction
    ids), else drawn from ``generator``.  Each record chunk is one
    ``op.gs_sweep`` / ``op.rk_sweep`` call, or with ``block > 1`` (block
    GS, dense or CSR) one ``op.block_gs_sweep`` call.  ``x0`` is not
    modified.
    """
    rec = resolve_record_every(num_iters, record_every)
    picks = direction_stream(op, action, num_iters, generator=generator,
                             picks=picks, block=block)
    rn = op.row_norms_sq() if action == "rk" else None
    norm = "A" if action == "gs" else "euclid"
    x = x0
    errs, resids = [], []
    for c in range(num_iters // rec):
        x = sweep(op, b, x, picks[c * rec:(c + 1) * rec], action=action,
                  beta=beta, block=block, rn=rn)
        err, resid = record_metrics(op, b, x, x_star, norm=norm)
        errs.append(err)
        resids.append(resid)
    iters = (1 + torch.arange(num_iters // rec, device=x.device)) * rec
    return SolveResult(x=x, err_sq=torch.stack(errs),
                       resid=torch.stack(resids), iters=iters)


# ---------------------------------------------------------------------------
# Bounded-delay asynchronous simulator (the paper's Secs. 4/6 read models)
# ---------------------------------------------------------------------------

#: consistent-read delay schedules understood by ``solve_async_sim``
DELAY_MODES = ("fixed", "uniform", "cyclic")
#: read models understood by ``solve_async_sim``
READ_MODELS = ("consistent", "inconsistent")


def draw_delays(num_iters: int, tau: int, *, read_model: str,
                delay_mode: str, miss_prob: float,
                generator: torch.Generator | None) -> torch.Tensor:
    """The simulator's delay stream, on the generator's device (the CPU
    where none is needed).

    Consistent reads: ``(num_iters,)`` int32 delays s_j — ``"fixed"``
    s_j = tau, ``"uniform"`` s_j ~ U{0..tau} (drawn from ``generator``),
    ``"cyclic"`` s_j = j mod (tau + 1).  Inconsistent reads: a
    ``(num_iters, max(tau, 1))`` bool mask, each of the last tau updates
    invisible with probability ``miss_prob`` (drawn from ``generator``).
    """
    if read_model == "consistent":
        if delay_mode == "fixed":
            return torch.full((num_iters,), tau, dtype=torch.int32)
        if delay_mode == "cyclic":
            return (torch.arange(num_iters) % (tau + 1)).to(torch.int32)
        if delay_mode != "uniform":
            raise ValueError(f"unknown delay_mode: {delay_mode!r} (expected "
                             f"one of {DELAY_MODES})")
    elif read_model != "inconsistent":
        raise ValueError(f"unknown read_model: {read_model!r} (expected one "
                         f"of {READ_MODELS})")
    if generator is None:
        raise ValueError(
            f"{read_model} reads with delay_mode={delay_mode!r} draw their "
            "delays: pass a delay_generator or delays")
    if read_model == "consistent":
        return torch.randint(0, tau + 1, (num_iters,), generator=generator,
                             dtype=torch.int32, device=generator.device)
    return torch.rand((num_iters, max(tau, 1)), generator=generator,
                      device=generator.device) < miss_prob


def _host_delays(delays, num_iters: int, tau: int,
                 read_model: str) -> np.ndarray:
    """A given delay stream as a checked numpy array: (num_iters,) delays
    in [0, tau] for consistent reads, a (num_iters, max(tau, 1)) mask for
    inconsistent ones."""
    d = np.asarray(torch.as_tensor(delays).cpu())
    if read_model == "consistent":
        if d.shape != (num_iters,):
            raise ValueError(f"delays has shape {d.shape}, expected "
                             f"({num_iters},) for consistent reads")
        d = d.astype(np.int64)
        if d.size and (d.min() < 0 or d.max() > tau):
            raise ValueError(f"delays span [{d.min()}, {d.max()}], allowed "
                             f"[0, {tau}]")
        return d
    if d.shape != (num_iters, max(tau, 1)):
        raise ValueError(f"delays has shape {d.shape}, expected "
                         f"({num_iters}, {max(tau, 1)}) for inconsistent "
                         "reads")
    return d.astype(bool)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the card: a copy
    from pinned memory, queued on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def solve_async_sim(
    op,
    b: torch.Tensor,
    x0: torch.Tensor,
    x_star: torch.Tensor | None,
    *,
    action: str,
    num_iters: int,
    tau: int,
    generator: torch.Generator | None = None,
    picks: torch.Tensor | None = None,
    delay_generator: torch.Generator | None = None,
    delays: torch.Tensor | None = None,
    beta: float = 1.0,
    read_model: str = "consistent",
    delay_mode: str = "fixed",
    miss_prob: float = 0.5,
    record_every: int = 0,
) -> SolveResult:
    """Faithful simulator of delays bounded by ``tau`` (consistent and
    inconsistent reads), for both the coordinate ("gs") and row ("rk")
    actions.  A ring buffer holds the last ``max(tau, 1)`` applied update
    amounts; the stale read is rebuilt exactly via

        A_r x_stale = A_r x - sum_{t invisible} c_t * w(r, r_t)

    with ``w`` the coupling ``A[r, r_t]`` for the coordinate action and the
    row inner product ``<A_r, A_{r_t}>`` for the row action (which divides
    by ``||A_r||^2``).  Consistent reads miss the last s_j updates
    (``delay_mode``, see ``draw_delays``); inconsistent reads miss each of
    the last tau updates by a Bernoulli mask.

    Streams: ``picks`` or a draw of ``generator`` (``draw_picks``), and
    ``delays`` or a draw of ``delay_generator`` (``draw_delays``),
    independent of each other (Assumption A-4).  Both are read to the host
    once; the ring slots and invisible updates of every step are worked
    out there and copied to the device once per record chunk, so the steps
    themselves (a few launches each) never wait for the card.  A GS step
    with nothing invisible takes ``DenseOp.gs_sweep``'s exact calls, so at
    ``tau = 0`` the GS iterates are bitwise the sequential engine's on the
    same picks.  The row action keeps the reference simulator's arithmetic
    (``x += A_r * (beta * gamma)``).

    Sparse operators are densified exactly (with a ``UserWarning``): the
    correction needs arbitrary couplings and row inner products, so the
    simulator — a research tool for delay models, not a performance path —
    reads dense rows whatever the format.
    """
    if not isinstance(op, DenseOp):
        if not hasattr(op, "to_dense"):
            raise NotImplementedError(
                "the async simulator needs a densifiable operator "
                f"(got {type(op).__name__})")
        # to_dense() reconstructs the stored values bit for bit, so the
        # simulated iterates are exact; only the cost model changes.
        warnings.warn(
            f"solve_async_sim densifies {type(op).__name__} exactly: the "
            "bounded-delay simulator ignores the format's sparsity and "
            "pays dense row reads per step (it is a research tool for delay "
            "models, not a sparse performance path — use solve_distributed "
            "for sparse-aware execution)", UserWarning, stacklevel=2)
        op = DenseOp(op.to_dense())
    if action not in ("gs", "rk"):
        raise ValueError(f"unknown action: {action!r}")
    if read_model not in READ_MODELS or delay_mode not in DELAY_MODES:
        raise ValueError(f"unknown read_model {read_model!r} or delay_mode "
                         f"{delay_mode!r} (expected one of {READ_MODELS}, "
                         f"{DELAY_MODES})")
    if tau < 0:
        raise ValueError(f"tau must be >= 0, got {tau}")
    rec = resolve_record_every(num_iters, record_every)
    t_buf = max(tau, 1)
    dev = op.device
    if picks is None:
        if generator is None:
            raise ValueError("the async simulator needs a generator or picks")
        picks = draw_picks(op, action, num_iters, generator=generator)
    p = np.asarray(torch.as_tensor(picks).cpu()).astype(np.int64)
    if p.shape != (num_iters,):
        raise ValueError(f"picks has shape {p.shape}, expected ({num_iters},)")
    if p.size and (p.min() < 0 or p.max() >= op.shape[0]):
        raise IndexError(f"pick ids span [{p.min()}, {p.max()}], allowed "
                         f"[0, {op.shape[0]})")
    if delays is None:
        delays = draw_delays(num_iters, tau, read_model=read_model,
                             delay_mode=delay_mode, miss_prob=miss_prob,
                             generator=delay_generator)
    d = _host_delays(delays, num_iters, tau, read_model)

    A = op.A
    rn = op.row_norms_sq() if action == "rk" else None
    norm = "A" if action == "gs" else "euclid"
    x = x0.clone()
    ring = torch.zeros((t_buf, b.shape[1]), dtype=x.dtype, device=dev)
    offsets = np.arange(t_buf)
    errs, resids = [], []
    for c in range(num_iters // rec):
        # Host plan of the chunk: for step j, the iterations it misses,
        # newest first, as (pick, ring slot) pairs at [ptr[j], ptr[j+1]).
        js = np.arange(c * rec, (c + 1) * rec)
        it = js[:, None] - 1 - offsets[None, :]
        if read_model == "consistent":
            inv = (offsets[None, :] < d[js, None]) & (it >= 0)
        else:
            inv = d[js] & (it >= 0) & (offsets[None, :] < tau)
        ptr = np.concatenate([[0], np.cumsum(inv.sum(1))]).tolist()
        missed = it[inv]
        if missed.size:
            rs = _upload(p[missed], dev)
            slots = _upload(missed % t_buf, dev)
        for i, (j, r) in enumerate(zip(js.tolist(), p[js].tolist())):
            lo, hi = ptr[i], ptr[i + 1]
            row = A[r].to(x.dtype)
            gamma = b[r] - row @ x
            if hi > lo:
                w = (row.index_select(0, rs[lo:hi]) if action == "gs"
                     else A.index_select(0, rs[lo:hi]).to(x.dtype) @ row)
                gamma = gamma + w @ ring.index_select(0, slots[lo:hi])
            if action == "gs":
                applied = beta * gamma
                x[r] += applied
            else:
                applied = beta * (gamma / rn[r])
                x += row[:, None] * applied[None, :]
            if tau > 0:
                ring[j % t_buf] = applied
        err, resid = record_metrics(op, b, x, x_star, norm=norm)
        errs.append(err)
        resids.append(resid)
    iters = (1 + torch.arange(num_iters // rec, device=x.device)) * rec
    return SolveResult(x=x, err_sq=torch.stack(errs),
                       resid=torch.stack(resids), iters=iters)


# ---------------------------------------------------------------------------
# Batched-RHS chunked entry (the serving layer's engine surface)
# ---------------------------------------------------------------------------

class BatchedSolveResult(NamedTuple):
    x: torch.Tensor          # (n, k) iterate after the last executed chunk
    resid: torch.Tensor      # (k,) ||b - A x||_2 at exit, per RHS column
    #: (k,) int32 on the host: record chunks each column needed to reach
    #: ITS tolerance (columns that never reached it report the chunks run)
    rounds: torch.Tensor
    converged: torch.Tensor  # (k,) bool on the host: resid <= tol at a record
    iters_run: int           # iterations actually executed (<= num_iters)


def sequential_chunk(op, b, x, picks, *, action: str, beta: float = 1.0,
                     block: int = 1, rn: torch.Tensor | None = None):
    """One record chunk of the sequential engine: ``picks.shape[0]`` steps
    from iterate ``x``; returns ``(x_next, resid)`` with ``resid`` the
    per-column ``||b - A x_next||_2``.

    The chunk is the step ``solve_sequential`` takes per record: one
    ``op.gs_sweep`` / ``op.rk_sweep`` (``op.block_gs_sweep`` for block GS,
    ``block > 1``), then the residual half of ``record_metrics``
    (``op.matvec`` and ``ops.colsum``).  On a CSR operator on the card
    that is three launches: the sweep, the CSR matvec and ``colsum``.  So
    chaining chunks over consecutive slices of one stream gives bitwise the
    final ``x`` of ``solve_sequential`` on that stream.  ``rn`` is the
    Kaczmarz divisor (``op.row_norms_sq()`` when None); a caller running
    many chunks computes it once.  The reference's ``fused=`` is gone: the
    port has one engine, whose chunk is always one sweep call.
    """
    if action == "rk" and rn is None:
        rn = op.row_norms_sq()
    with span("engine.sweep"):
        x = sweep(op, b, x, picks, action=action, beta=beta, block=block,
                  rn=rn)
    with span("engine.record"):
        r = b - op.matvec(x)
        resid = torch.sqrt(ops.colsum(r * r))
    return x, resid


def solve_batched(
    op,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    action: str,
    num_iters: int,
    tol,
    generator: torch.Generator | None = None,
    picks: torch.Tensor | None = None,
    record_every: int = 0,
    beta: float = 1.0,
    block: int = 1,
    on_record=None,
) -> BatchedSolveResult:
    """Sequential solve over the multi-RHS axis with per-column tolerances
    and per-column round counts.

    ``tol`` is an absolute residual target: a scalar or a ``(k,)`` array,
    one entry per RHS column (the serving layer batches independent
    tenants' requests onto the columns, each with its own tolerance).  The
    solve runs record chunk by record chunk (``record_every`` iterations
    each, checked by ``resolve_record_every``) and exits early once every
    column has met its tolerance; a column's ``rounds`` entry is the
    number of chunks it needed.  Columns are independent under both
    actions and every kernel of a chunk gives a column the same bits
    whatever the column count, so each column's trajectory is bitwise the
    one it would have had in any other batch on the same stream.

    The stream is ``picks`` when given, else drawn from ``generator`` (a
    ``torch.Generator``: a different stream from the reference's
    ``jax.random`` key), once per solve, as contiguous int32.  The only
    host read per chunk is the residual, for the tolerance test.

    ``on_record(chunk_idx, x, resid, converged) -> bool`` is called at
    every record point (``converged`` a host bool tensor); returning False
    stops the solve after that chunk.  Each chunk is ``sequential_chunk``;
    the reference's ``chunk_fn=`` (a cached compiled chunk) and ``fused=``
    are gone: the port compiles nothing per call and has one engine.
    """
    with span("solve_batched"):
        if num_iters <= 0:
            raise ValueError(f"num_iters must be > 0 (got {num_iters})")
        rec = resolve_record_every(num_iters, record_every)
        chunks = num_iters // rec
        with span("engine.picks"):
            picks = direction_stream(op, action, num_iters,
                                     generator=generator, picks=picks,
                                     block=block)
        k = b.shape[1]
        if x0 is None:
            n_x = op.shape[0] if action == "gs" else op.shape[1]
            x0 = torch.zeros((n_x, k), dtype=b.dtype, device=b.device)
        tol = torch.as_tensor(tol, dtype=torch.float32).cpu().broadcast_to(
            (k,))
        rn = op.row_norms_sq() if action == "rk" else None
        x, resid = x0, None
        rounds = torch.zeros((k,), dtype=torch.int32)
        conv = torch.zeros((k,), dtype=torch.bool)
        ran = 0
        for c in range(chunks):
            x, resid = sequential_chunk(op, b, x, picks[c * rec:(c + 1) * rec],
                                        action=action, beta=beta, block=block,
                                        rn=rn)
            ran = c + 1
            with span("engine.wait"):
                host = resid.cpu()
            with span("engine.exit"):
                newly = ~conv & (host <= tol)
                rounds[newly] = ran
                conv |= newly
                go = on_record is None or bool(on_record(c, x, resid,
                                                         conv.clone()))
                if bool(conv.all()) or not go:
                    break
        rounds = torch.where(conv, rounds, ran).to(torch.int32)
    return BatchedSolveResult(x=x, resid=resid, rounds=rounds, converged=conv,
                              iters_run=ran * rec)


def solve(
    problem,
    *,
    schedule: Schedule,
    format: str = "dense",
    action: str | None = None,
    generator: torch.Generator | None = None,
    picks: torch.Tensor | None = None,
    beta: float = 1.0,
    block: int = 128,
    bands: int = 2,
    width: int | None = None,
    rows_per_panel: int | None = None,
    storage_dtype=None,
    gs_block: int = 1,
    x0: torch.Tensor | None = None,
    group=None,
    sync: str = "auto",
    seed: int | None = None,
    with_metrics: bool = True,
    delay_generator: torch.Generator | None = None,
    delays: torch.Tensor | None = None,
    read_model: str = "consistent",
    delay_mode: str = "fixed",
    miss_prob: float = 0.5,
):
    """One front door for the solver family, on the device of the
    problem's tensors.

    ``problem`` is an ``SPDProblem`` (GS action by default) or an
    ``LSQProblem`` (Kaczmarz by default).  ``format`` picks the operator
    ("dense", "banded", "ell" or "csr"); ``block``/``bands`` shape the
    banded format, ``width`` the ELL format (``None``: every row's nonzeros
    fit; a smaller width keeps each row's largest), ``rows_per_panel``
    the CSR panel layout (``None``: the tuning table's winner at this
    shape, else 8; the panel grouping never changes a row's summation
    order), ``storage_dtype`` the coefficient precision (``None`` keeps
    the input dtype; the iterate, ``b`` and all accumulation stay f32),
    and ``gs_block`` the block-GS granularity on the dense and CSR formats
    (1: coordinate GS; the distributed sparse strategies refuse another).

    A sequential ``schedule`` draws its direction stream from
    ``generator`` (``seed`` raises) or takes ``picks``.  With ``tau > 0``
    it runs the bounded-delay simulator (``solve_async_sim``), whose delays
    come from ``delay_generator`` or ``delays`` (one of them is required,
    as the reference requires its ``delay_key``), under ``read_model``,
    ``delay_mode`` and ``miss_prob``.  A distributed one (``rounds``,
    ``local_steps``) runs ``core.distributed.solve_distributed`` on the
    ``torch.distributed`` process group ``group`` (the counterpart of the
    reference's ``mesh``): every rank calls ``solve`` with the whole
    problem, ``sync`` picks the collective, the streams come from
    ``seed`` (the same on every rank) or from ``picks``, the schedule's
    ``partition``, ``overlap`` and ``compress`` pass through, and
    ``with_metrics=False`` leaves the records zero; the result is a
    ``ParallelSolveResult`` (see ``solve_distributed`` for its ``x``).
    """
    if action is None:
        action = "rk" if hasattr(problem, "sigma_min") else "gs"
    schedule.validate()
    if rows_per_panel is None:
        rows_per_panel = tune_runtime.tuned_rows_per_panel(
            problem.A.shape[0], storage_dtype) or 8
    op = as_operator(problem.A, format, block=block, bands=bands, width=width,
                     rows_per_panel=rows_per_panel,
                     storage_dtype=storage_dtype)
    if x0 is None:
        # From b and the operator, not from x_star (which may be None): the
        # RK iterate lives in column space while b lives in row space.
        n_x = op.shape[0] if action == "gs" else op.shape[1]
        x0 = torch.zeros((n_x, problem.b.shape[1]), dtype=problem.b.dtype,
                         device=problem.b.device)
    if schedule.distributed:
        if group is None:
            raise ValueError("a distributed Schedule needs a group (a "
                             "torch.distributed process group)")
        if generator is not None:
            raise ValueError("a distributed solve draws its streams from "
                             "seed=, the same on every rank, not from a "
                             "generator")
        from repro_torch.core.distributed import solve_distributed
        return solve_distributed(
            op, problem.b, x0, problem.x_star, action=action, group=group,
            rounds=schedule.rounds, local_steps=schedule.local_steps,
            block=gs_block, beta=beta, sync=sync, seed=seed, picks=picks,
            with_metrics=with_metrics, partition=schedule.partition,
            overlap=schedule.overlap, compress=schedule.compress)
    if seed is not None:
        raise ValueError("a sequential solve draws its stream from "
                         "generator= (or takes picks=), not from seed=")
    if schedule.tau > 0:
        if delay_generator is None and delays is None:
            raise ValueError("the bounded-delay simulator needs a "
                             "delay_generator or delays")
        if gs_block != 1:
            raise ValueError(f"gs_block={gs_block}: the bounded-delay "
                             "simulator steps coordinates or rows")
        return solve_async_sim(
            op, problem.b, x0, problem.x_star, action=action,
            num_iters=schedule.num_iters, tau=schedule.tau,
            generator=generator, picks=picks,
            delay_generator=delay_generator, delays=delays, beta=beta,
            read_model=read_model, delay_mode=delay_mode,
            miss_prob=miss_prob, record_every=schedule.record_every)
    return solve_sequential(
        op, problem.b, x0, problem.x_star, action=action,
        num_iters=schedule.num_iters, generator=generator, picks=picks,
        beta=beta, block=gs_block, record_every=schedule.record_every)
