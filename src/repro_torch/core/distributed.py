"""The distributed engine on ``torch.distributed`` (port of the distributed
section of ``repro/core/engine.py``: ``solve_distributed`` with every
Gauss-Seidel and Kaczmarz strategy of the reference's table).

SPMD, as ``shard_map`` is: every rank of the process group calls
``solve_distributed`` with the whole problem and takes its own slab of
rows (what the reference's ``in_specs`` do).  A round is one local phase
of ``local_steps`` updates, then the round's exchange, then the records
(zeros with ``with_metrics=False``, and no record collective).  At P = 1
no collective runs.

The local phase is ONE kernel launch per round per rank on the card (the
reference's per-step scan is not ported, as in the sequential engine):

* ``sparse_gs`` (CSR, ELL): ``sweep_rows_gs`` over the rank's slab of
  ``padded_rows()`` on its full-length replica, its writes offset by the
  slab's first row (``write_base``);
* ``banded_gs`` and ``halo_gs``: ``banded_gs_sweep`` over the rank's
  halo-padded window of ``packed_band_tiles()``;
* ``dense_gs``: ``block_gs_sweep`` on the rank's replica, its picks the
  global ids of the rank's blocks;
* ``sparse_rk`` (CSR, ELL): ``sweep_rows_rk_delta``; ``banded_rk``:
  ``banded_rk_sweep``;
* ``dense_rk``: ``sweep_rows_rk_delta`` over the rank's dense slab as row
  windows of width n (column ids ``arange(n)``, built once a solve) with
  one all-zero row appended (b 0, rn 1): the global stream's picks the
  rank does not own are mapped onto it and add exact zeros, as the
  reference's masked step does, with no gate and no host read.

The records' products go through the port's kernels (``spmv_ell`` over
the rank's row windows, ``bbmv``, ``colsum``; a dense slab's rows through
``torch.matmul`` in ``DenseOp.matvec``'s 64-column groups), so on the card
no plain version runs.

Exchanges.  GS: the all-gather of the owned slabs (``dist.all_gather``,
list form); the neighbor all-to-all of ``sparse_gs`` (``sync="a2a"``: one
rotation per distinct slab offset of the operator's ``slab_neighbors``
graph, a rank's slab sent only to the ranks whose rows read it;
all-gather where every rank reads every slab); and the halo exchange of
``halo_gs`` (two edges of ``bands * block`` rows to the neighbors of a
chain).  Point-to-point payloads go through ``dist.batch_isend_irecv``
(``_P2P``).  gloo's send and receive hand a tensor's address to its TCP
transport, which reads and writes host memory, so a payload on the card is
staged, explicitly, through a pinned host buffer reused for the whole
solve; compute stays on the card.

The Kaczmarz delta sum (``_DeltaSync``) adds the ranks in rank order 0, 1,
..., P-1, by construction, on every strategy: gloo's ``all_reduce`` names
no order of summation.  Where P divides n, column slab c (``n / P`` rows)
belongs to rank c; each rank sends its delta's slab c to rank c, the owner
adds the P terms left to right, and the summed slabs travel back: under
``sync="psum"`` to every rank (one all-gather), under ``sync="a2a"`` only
to the ranks whose rows read the slab (the reference's two-phase exchange
over the column-slab graph), a rank that never reads a slab sending
nothing and the owner adding an exact zero in its place.  Every rank
applies ``x_c + (S_c - delta_c)`` to the slabs it holds, so the two syncs
compute bitwise the same iterate; a2a falls back to the psum where the
column graph is dense or P does not divide n, as the reference's does.
The returned x is assembled from the owners' column slabs (one more
all-gather), bitwise the same on every rank.  Where P does not divide n
(``dense_rk`` only) the deltas are all-gathered and each rank adds them in
rank order; its replica is returned.  The wire of the psum carries the
reduce-to-owner (each rank sends (P-1)/P of its delta) and the all-gather
of the sums (another (P-1)/P of a delta per rank): a ring all-reduce's
bytes.  ``bytes_per_round`` stays the reference's analytic model.

``overlap=True`` (``sparse_gs``, ``halo_gs``, ``sparse_rk``): round r's
exchange carries the payload captured at the end of round r-1 (own slab,
edges, round delta), so reads are one round staler.  The exchange is
posted before the round's kernel launch and waited for after it
(``async_op=True`` collectives, ``batch_isend_irecv`` left unwaited; a
staged payload's pinned buffer is not reused before its request ends).
``sparse_rk`` flushes the last round's delta with one trailing exchange.
Each rank's count of committed updates is exchanged every round (an
all-gather of the counters and a max-reduce), which gives the ``lag``
trace the reference measures.  Other strategies run lockstep rounds with
the reference's warning.

``compress`` (``sparse_rk``, ``halo_gs``): the payload crosses the wire as
the codec's f32 round trip (``optim.compression``), as the reference's
does.  ``sparse_rk``: a rank's own updates stay exact and foreign ones
arrive rounded; ``int8_ef`` carries the error-feedback residual through
the rounds and flushes it with one exact trailing exchange (after the
overlap flush when both are on); under ``sync="a2a"`` it falls back to the
psum with the reference's warning.  ``halo_gs``: the edges are quantized,
with no feedback; the records' ``x_star`` halos travel exact.  Other
strategies run the f32 payload with the reference's warning.

``partition="balanced"`` (CSR, ELL): the problem is permuted once, up
front (``core.partition``); the GS iterate is un-permuted, the Kaczmarz
iterate (column space) is left alone.

Pick streams: ``picks=`` overrides them; otherwise they are drawn with a
``torch.Generator`` (a different stream from the reference's threefry
key).  The GS strategies draw each rank's ``(rounds, local_steps)``
slab-local ids (rows, blocks of ``block`` rows, or block rows) uniformly
from ``seed * P + rank``, where the reference draws
``randint(fold_in(split(key, rounds)[r], rank))``; ``banded_rk`` and
``dense_rk`` draw one global stream (block rows ∝ panel norms, rows ∝ row
norms), the same on every rank, from ``seed``; ``sparse_rk`` draws each
rank's rows ∝ its slab's row norms from ``seed * P + rank`` (the
counterpart of ``fold_in(key, rank)``).

The result's ``x``: the GS strategies return the assembled global
iterate, each slab from its owner (the last round's all-gather, or one
more all-gather under ``a2a`` and ``halo``, where a rank's replica holds
stale remote slabs or only its window), bitwise the same on every rank,
as the reference assembles it through its ``out_specs``; the Kaczmarz
strategies as said above.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.engine import (COMPRESS_MODES, PARTITIONS,
                                     ParallelSolveResult,
                                     _warn_compress_fallback,
                                     _warn_overlap_fallback, sample_rows,
                                     scheduled_tau)
from repro_torch.core.operators import (DenseOp, _index_dtype,
                                        banded_window_matvec)
from repro_torch.kernels import ops
from repro_torch.optim import compression

#: action x format x sync -> strategy, the reference's table.  The sparse
#: strategies are format-generic: any operator exposing ``padded_rows()``
#: slots in.
_DISTRIBUTED_STRATEGIES = {
    ("gs", "DenseOp", "allgather"): "dense_gs",
    ("gs", "BlockBandedOp", "allgather"): "banded_gs",
    ("gs", "BlockBandedOp", "halo"): "halo_gs",
    ("gs", "EllOp", "allgather"): "sparse_gs",
    ("gs", "EllOp", "a2a"): "sparse_gs",
    ("gs", "CsrOp", "allgather"): "sparse_gs",
    ("gs", "CsrOp", "a2a"): "sparse_gs",
    ("rk", "DenseOp", "psum"): "dense_rk",
    ("rk", "BlockBandedOp", "psum"): "banded_rk",
    ("rk", "EllOp", "psum"): "sparse_rk",
    ("rk", "EllOp", "a2a"): "sparse_rk",
    ("rk", "CsrOp", "psum"): "sparse_rk",
    ("rk", "CsrOp", "a2a"): "sparse_rk",
}

#: strategies with an overlapped (double-buffered) sync: round r's
#: exchange carries the payload captured at the end of round r-1.
_OVERLAP_STRATEGIES = frozenset({"halo_gs", "sparse_gs", "sparse_rk"})

#: strategies with a compressed wire: the RK delta sum and the banded halo
#: exchange.  A gathered slab IS the iterate, not a correction, so the
#: all-gathers stay f32.
_COMPRESS_STRATEGIES = frozenset({"sparse_rk", "halo_gs"})


def _payload_bytes(size: int, compress: str) -> float:
    """Wire bytes of one ``size``-element f32 payload under a codec."""
    if compress == "bf16":
        return 2.0 * size
    if compress == "int8_ef":
        blocks = -(-size // compression.BLOCK)
        return float(blocks * compression.BLOCK + 4 * blocks)  # q + scales
    return 4.0 * size


def _sync_bytes_per_round(kind: str, *, n: int, k: int, num_workers: int,
                          sync: str | None = None, halo: int = 0,
                          a2a_schedule=(), compress: str = "none") -> float:
    """Analytic per-round sync payload: bytes ONE rank sends per round,
    the reference's model.  ``halo`` is ``bands * block`` of ``halo_gs``;
    under the a2a exchanges the sends vary with the neighbor graph, so
    their total over the ranks is averaged over P.  At P = 1 no collective
    runs: 0 bytes."""
    if num_workers <= 1:
        return 0.0
    slab = n // num_workers
    if kind in ("dense_gs", "banded_gs"):
        return 4.0 * slab * k                      # all-gather of the slab
    if kind == "halo_gs":
        return 2.0 * _payload_bytes(halo * k, compress)   # two edges
    if kind == "sparse_gs":
        if sync == "a2a":
            sends = sum(len(pairs) for _, pairs in a2a_schedule)
            return 4.0 * slab * k * sends / num_workers
        return 4.0 * slab * k                      # all-gather of the slab
    if kind in ("dense_rk", "banded_rk"):
        return _payload_bytes(n * k, compress)     # full-delta sum
    if kind == "sparse_rk":
        if sync == "a2a":
            reduce_scheds, bcast_scheds = a2a_schedule
            sends = (sum(len(p) for p in reduce_scheds)
                     + sum(len(p) for p in bcast_scheds))
            return 4.0 * slab * k * sends / num_workers
        return _payload_bytes(n * k, compress)     # full-delta sum
    raise ValueError(kind)


def _a2a_plan(need: np.ndarray, num_workers: int):
    """The masked rotations of the sparse GS neighbor exchange, the
    reference's: one rotation per distinct slab offset ``s`` of the graph,
    carrying only the (sender v -> reader (v + s) mod P) pairs whose
    reader's rows read the sender's slab; ``masks[w, i]`` says whether
    rank w takes the slab arriving over rotation i."""
    P = num_workers
    shifts = sorted({(w - v) % P for w in range(P) for v in range(P)
                     if need[w, v] and w != v})
    schedule = tuple((s, tuple((v, (v + s) % P) for v in range(P)
                               if need[(v + s) % P, v]))
                     for s in shifts)
    masks = np.array([[bool(need[w, (w - s) % P]) for s in shifts]
                      for w in range(P)], bool).reshape(P, len(shifts))
    return schedule, masks


def _rk_a2a_plan(need: np.ndarray, num_workers: int):
    """The reference's schedules of the Kaczmarz a2a exchange over the
    column-slab graph (``need[w, c]``: rank w's rows reference column slab
    c): per shift s, the (v -> (v + s) mod P) pairs of the reduce to the
    owners and the (c -> (c + s) mod P) pairs of the broadcast back."""
    P = num_workers
    reduce_scheds = tuple(
        tuple((v, (v + s) % P) for v in range(P) if need[v, (v + s) % P])
        for s in range(1, P))
    bcast_scheds = tuple(
        tuple((c, (c + s) % P) for c in range(P)
              if need[(c + s) % P, c] and (c + s) % P != c)
        for s in range(1, P))
    return reduce_scheds, bcast_scheds


def _all_reduce(t: torch.Tensor, group, num_workers: int) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor); ``t`` itself at
    P = 1, where no collective runs.  The records' sums only: gloo names
    no order of summation, and the delta sums keep theirs
    (``_DeltaSync``)."""
    if num_workers == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _post_all_gather(own: torch.Tensor, group, num_workers: int):
    """Post the all-gather of every rank's ``own`` (``async_op``); the
    returned function waits for it and gives the slabs stacked in rank
    order (a new tensor, the same on every rank; ``own`` itself at P = 1)."""
    if num_workers == 1:
        return lambda: own
    parts = [torch.empty_like(own) for _ in range(num_workers)]
    work = dist.all_gather(parts, own.contiguous(), group=group,
                           async_op=True)

    def finish():
        work.wait()
        return torch.cat(parts, 0)
    return finish


def _all_gather(own: torch.Tensor, group, num_workers: int) -> torch.Tensor:
    return _post_all_gather(own, group, num_workers)()


class _P2P:
    """The point-to-point exchanges of one solve on ``group``.

    ``post`` posts a round's sends and receives in one
    ``dist.batch_isend_irecv`` and returns a function that waits for them;
    ``exchange`` does both.  A tensor on the card travels through a pinned
    host buffer (gloo's TCP transport reads and writes host memory): one
    buffer per distinct payload sent and per peer received from, allocated
    at first use and reused for the whole solve.  The copies into the send
    buffers are synchronous; a caller posts again only after the last
    post's wait, so no buffer is overwritten under a request in flight.
    """

    def __init__(self, group):
        self.group = group
        self._bufs: dict = {}

    def _staging(self, key, like: torch.Tensor) -> torch.Tensor | None:
        if like.device.type == "cpu":
            return None
        buf = self._bufs.get(key)
        if buf is None or buf.shape != like.shape:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._bufs[key] = buf
        return buf

    def post(self, sends, recvs):
        """``sends``: (peer, tensor) pairs; ``recvs``: (peer, out) pairs,
        each ``out`` (a contiguous tensor, a view too) filled with what its
        peer sent by the time the returned function returns.  Peers are
        ranks of the group; between two ranks at most one payload travels
        each way."""
        p2p, landed, staged = [], [], {}
        for peer, t in sends:
            buf = staged.get(id(t))
            if buf is None:
                buf = self._staging(("send", len(staged)), t)
                if buf is None:
                    buf = t.contiguous()
                else:
                    buf.copy_(t)
                staged[id(t)] = buf
            p2p.append(dist.P2POp(dist.isend, buf, self._global(peer),
                                  self.group))
        for peer, out in recvs:
            buf = self._staging(("recv", peer), out)
            if buf is not None:
                landed.append((buf, out))
            p2p.append(dist.P2POp(dist.irecv, out if buf is None else buf,
                                  self._global(peer), self.group))
        reqs = dist.batch_isend_irecv(p2p) if p2p else []

        def finish():
            for req in reqs:
                req.wait()
            for buf, out in landed:
                out.copy_(buf)
        return finish

    def exchange(self, sends, recvs) -> None:
        self.post(sends, recvs)()

    def _global(self, peer: int) -> int:
        return dist.get_global_rank(self.group, peer)


class _Lag:
    """The measured staleness of an overlapped run, as the reference
    measures it: each round every rank's count of committed updates is
    all-gathered, ``lag`` is the largest count of foreign updates a rank
    has not yet seen (a max over the ranks), and the seen counts move up.
    The counters live on the CPU under gloo (on the card under nccl)."""

    def __init__(self, group, rank, num_workers, local_steps, device):
        dev = (torch.device("cpu") if num_workers == 1
               or dist.get_backend(group) == "gloo" else device)
        self.group, self.P, self.L, self.device = (group, num_workers,
                                                   local_steps, device)
        self.cnt = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.seen = torch.zeros((num_workers,), dtype=torch.int64, device=dev)
        self.foreign = torch.arange(num_workers, device=dev) != rank
        self.trace = []

    def round(self) -> None:
        cnt_all = _all_gather(self.cnt, self.group, self.P)
        lag = torch.where(self.foreign, cnt_all - self.seen, 0).sum()
        if self.P > 1:
            lag = lag.reshape(1)
            dist.all_reduce(lag, op=dist.ReduceOp.MAX, group=self.group)
        self.seen = torch.where(self.foreign, cnt_all, self.seen)
        self.cnt = self.cnt + self.L
        self.trace.append(lag.reshape(()))

    def result(self) -> torch.Tensor:
        return torch.stack(self.trace).to(torch.int32).to(self.device)


def _caller_picks(picks, shape, hi: int, device) -> torch.Tensor:
    """A caller's pick ids as an int64 tensor of ``shape`` on ``device``,
    every id in [0, hi)."""
    picks = torch.as_tensor(picks, device=device)
    if tuple(picks.shape) != shape:
        raise ValueError(f"picks has shape {tuple(picks.shape)}, expected "
                         f"{shape}")
    lo, top = (int(v) for v in torch.aminmax(picks))
    if lo < 0 or top >= hi:
        raise IndexError(f"pick ids span [{lo}, {top}], allowed [0, {hi})")
    return picks.long()


def _gs_picks(picks, seed, *, rounds, num_workers, local_steps, hi, rank,
              device) -> torch.Tensor:
    """The rank's (rounds, local_steps) slab-local GS ids in [0, hi) as
    contiguous int32: its column of the caller's (rounds, P, local_steps)
    ``picks``, else uniform draws of a generator seeded
    ``seed * P + rank``."""
    if picks is None:
        gen = torch.Generator(device=device).manual_seed(
            seed * num_workers + rank)
        mine = torch.randint(0, hi, (rounds, local_steps), generator=gen,
                             device=device)
    else:
        mine = _caller_picks(picks, (rounds, num_workers, local_steps), hi,
                             device)[:, rank]
    return mine.to(torch.int32).contiguous()


def solve_distributed(
    op,
    b: torch.Tensor,
    x0: torch.Tensor,
    x_star: torch.Tensor | None = None,
    *,
    action: str = "gs",
    group,
    rounds: int,
    local_steps: int,
    block: int = 1,
    beta: float = 1.0,
    sync: str = "auto",
    seed: int | None = None,
    picks: torch.Tensor | None = None,
    with_metrics: bool = True,
    partition: str = "contiguous",
    overlap: bool = False,
    compress: str = "none",
) -> ParallelSolveResult:
    """P-way solve under the periodic-synchronization schedule; call it on
    every rank of ``group`` with the same arguments.

    ``sync="auto"`` resolves as the reference's rule does: Kaczmarz takes
    the a2a exchange on CSR/ELL and the psum elsewhere; GS takes the halo
    exchange where the operator has a finite ``halo_width``
    (block-banded), the a2a exchange where it answers ``slab_neighbors``
    (CSR, ELL) and the all-gather elsewhere (dense).  ``block`` is the
    dense block-GS granularity (``gs_block``; the sparse slab strategies
    run coordinate GS and refuse another).  ``picks`` (else ``seed``)
    gives the streams: ``(rounds, P, local_steps)`` slab-local ids for the
    GS strategies (rows, blocks of ``block`` rows, block rows) and
    ``sparse_rk``, ``(rounds, local_steps)`` global ids for ``banded_rk``
    (block rows) and ``dense_rk`` (rows).  ``partition``, ``overlap`` and
    ``compress`` as in the module's docstring and ``Schedule``.  With
    ``with_metrics=False`` the records are zeros and cost nothing.  ``x0``
    is not modified.
    """
    if rounds <= 0 or local_steps <= 0:
        raise ValueError(f"need rounds > 0 and local_steps > 0 (got "
                         f"{rounds}, {local_steps})")
    num_workers = dist.get_world_size(group)
    rank = dist.get_rank(group)
    row_perm = None
    if partition == "balanced":
        from repro_torch.core import partition as partition_lib
        op, b, x0, x_star, row_perm = partition_lib.apply_partition(
            op, b, x0, x_star, action=action, num_slabs=num_workers)
    elif partition not in PARTITIONS:
        raise ValueError(
            f"unknown partition: {partition!r} (expected one of "
            f"{PARTITIONS})")
    if sync == "auto":
        if action == "rk":
            sync = "a2a" if hasattr(op, "slab_neighbors") else "psum"
        elif op.halo_width is not None:
            sync = "halo"
        elif hasattr(op, "slab_neighbors"):
            sync = "a2a"
        else:
            sync = "allgather"
    kind = _DISTRIBUTED_STRATEGIES.get((action, type(op).__name__, sync))
    if kind is None:
        supported = "\n  ".join(
            f"action={a!r} x format={f} x sync={s!r}"
            for (a, f, s) in sorted(_DISTRIBUTED_STRATEGIES))
        raise NotImplementedError(
            f"no distributed strategy for action={action!r}, "
            f"format={type(op).__name__}, sync={sync!r}; supported "
            f"combinations:\n  {supported}")
    if kind == "sparse_gs" and block != 1:
        raise NotImplementedError(
            f"distributed block GS with block={block} is not supported for "
            f"{type(op).__name__}; the sparse slab strategies run "
            "coordinate GS (block=1)")
    if overlap and kind not in _OVERLAP_STRATEGIES:
        _warn_overlap_fallback(op, action, kind)
        overlap = False
    if compress not in COMPRESS_MODES:
        raise ValueError(
            f"unknown compress: {compress!r} (expected one of "
            f"{COMPRESS_MODES})")
    if compress != "none" and kind not in _COMPRESS_STRATEGIES:
        _warn_compress_fallback(op, action, kind, compress)
        compress = "none"
    if compress != "none" and kind == "sparse_rk" and sync == "a2a":
        warnings.warn(
            f"compress={compress!r}: the a2a delta exchange is pinned "
            "bitwise to the psum reduction, which a lossy payload cannot "
            "preserve; running the compressed psum wire instead",
            UserWarning, stacklevel=2)
        sync = "psum"
    if picks is None and seed is None:
        raise ValueError("solve_distributed needs a seed or picks")
    n, k = x0.shape[0], b.shape[1]
    common = dict(group=group, rank=rank, num_workers=num_workers,
                  rounds=rounds, local_steps=local_steps, beta=beta,
                  seed=seed, picks=picks, with_metrics=with_metrics)
    schedule, masks, need = (), None, None
    if kind == "sparse_gs" and sync == "a2a":
        need = op.slab_neighbors(num_workers)
        if num_workers > 1 and bool(need.all()):
            # Every rank reads every slab: the rotations would move the
            # all-gather's bytes over P - 1 exchanges; one all-gather.
            sync = "allgather"
        else:
            schedule, masks = _a2a_plan(need, num_workers)
    elif kind == "sparse_rk" and sync == "a2a":
        need = op.slab_neighbors(num_workers)
        if num_workers > 1 and (bool(need.all()) or n % num_workers):
            # Dense column graph: every slab travels to every rank, one
            # sum of the full deltas moves the same bytes.  (P not
            # dividing n: no equal column slabs to own.)  The psum is
            # bitwise what a2a computes.
            sync = "psum"
        else:
            schedule = _rk_a2a_plan(need, num_workers)
    lag = None
    if kind == "sparse_gs":
        x, errs, resids, lag = _sparse_gs(
            op, b, x0, x_star, sync=sync, a2a_schedule=schedule,
            a2a_masks=masks, overlap=overlap, **common)
    elif kind == "banded_gs":
        x, errs, resids = _banded_gs(op, b, x0, x_star, **common)
    elif kind == "halo_gs":
        x, errs, resids, lag = _halo_gs(op, b, x0, x_star, overlap=overlap,
                                        compress=compress, **common)
    elif kind == "dense_gs":
        x, errs, resids = _dense_gs(op, b, x0, x_star, block=block, **common)
    elif kind == "sparse_rk":
        x, errs, resids, lag = _sparse_rk(
            op, b, x0, x_star, need=need if sync == "a2a" else None,
            overlap=overlap, compress=compress, **common)
    elif kind == "dense_rk":
        x, errs, resids = _dense_rk(op, b, x0, x_star, **common)
    else:
        x, errs, resids = _banded_rk(op, b, x0, x_star, **common)
    tau = scheduled_tau(num_workers, local_steps,
                        shared_stream=kind.endswith("_rk"),
                        local_sampling=kind == "sparse_rk", overlap=overlap)
    if row_perm is not None and action == "gs":
        # the coordinate iterate was permuted symmetrically; the Kaczmarz
        # one lives in column space and never was
        x = x[row_perm.inv]
    return ParallelSolveResult(
        x=x, err_sq=torch.stack(errs), resid=torch.stack(resids), tau=tau,
        lag=lag, bytes_per_round=_sync_bytes_per_round(
            kind, n=n, k=k, num_workers=num_workers, sync=sync,
            halo=op.halo_width or 0, a2a_schedule=schedule,
            compress=compress))


def _nan_err(x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[1],), math.nan, dtype=torch.float32,
                      device=x.device)


def _zeros(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((x.shape[1],), dtype=torch.float32, device=x.device)


def _no_records(x: torch.Tensor):
    """The records of ``with_metrics=False``: zeros, no collective."""
    return _zeros(x), _zeros(x)


def _records(parts, x, group, num_workers, have_err: bool):
    """(err_sq, resid) from a rank's partial sums ``parts`` (its squared
    residual, then its share of e^T A e where ``have_err``), summed over
    the ranks in one all-reduce."""
    tot = _all_reduce(torch.stack(parts), group, num_workers)
    err = tot[1] if have_err else _nan_err(x)
    return err, torch.sqrt(tot[0])


def _sparse_gs(op, b, x0, xs, *, group, rank, num_workers, rounds,
               local_steps, beta, seed, picks, with_metrics, sync,
               a2a_schedule, a2a_masks, overlap=False):
    """Row-sparse slab GS (CsrOp / EllOp), the format-generic strategy.

    Each rank owns a slab of rows in padded-row form (fixed-width windows
    with global column ids, ``op.padded_rows()``), keeps a full-length
    working replica whose own slab is fresh within a round, and refreshes
    it at the round's end by the all-gather or by the neighbor exchange
    (``sync="a2a"``): a rank receives only the slabs its rows read, over
    the masked rotations of ``a2a_schedule``.  The slabs a2a leaves stale are never read (a padding
    slot's column is the row's own under ELL, column 0 with value 0 under
    CSR: an exact zero either way), so the iterates and records are
    bitwise the all-gather's.  The records read only the rank's rows: its
    squared residual and its share of e^T A e, summed over the ranks.

    ``overlap=True`` exchanges the own slab captured at the END of round
    r-1 while round r's sweep runs on remote slabs one round staler; the
    all-gather's fresh own rows are spliced back over the stale gather,
    and a2a never writes the own slab.
    """
    n, k = b.shape
    if n % num_workers:
        raise ValueError(
            f"worker count ({num_workers}) must divide the row count ({n})")
    slab = n // num_workers
    row0 = rank * slab
    rows = slice(row0, row0 + slab)
    vals, cols = op.padded_rows()
    vals_sh, cols_sh = vals[rows], cols[rows]
    counts = op.stop_counts(k)
    counts_sh = None if counts is None else counts[rows]
    b_sh = b[rows]
    mine = _gs_picks(picks, seed, rounds=rounds, num_workers=num_workers,
                     local_steps=local_steps, hi=slab, rank=rank,
                     device=b.device)
    wire = _P2P(group)
    readers, sources = [], []
    for i, (shift, pairs) in enumerate(a2a_schedule):
        if (rank, (rank + shift) % num_workers) in pairs:
            readers.append((rank + shift) % num_workers)
        if a2a_masks[rank, i]:
            sources.append((rank - shift) % num_workers)

    def post(own):
        """Post the exchange of ``own``; the returned function installs
        what arrived into a replica whose own slab is fresh."""
        if num_workers == 1:
            return lambda xw: xw
        if sync == "allgather":
            gathered = _post_all_gather(own, group, num_workers)

            def install(xw):
                x2 = gathered()
                x2[rows] = xw[rows]
                return x2
            return install
        got = {v: torch.empty_like(own) for v in sources}
        landed = wire.post([(w, own) for w in readers], list(got.items()))

        def install(xw):
            landed()
            for v, slab_v in got.items():
                xw[v * slab:(v + 1) * slab] = slab_v
            return xw
        return install

    def matvec(v):
        return ops.spmv_ell(vals_sh, cols_sh, v, n_cols=n, counts=counts_sh)

    def metrics(xw):
        res = b_sh - matvec(xw)
        parts = [ops.colsum(res * res)]
        if xs is not None:
            e = xw - xs
            parts.append(ops.colsum(e[rows] * matvec(e)))
        return _records(parts, xw, group, num_workers, xs is not None)

    lag = _Lag(group, rank, num_workers, local_steps, b.device) if overlap \
        else None
    xw = x0
    errs, resids = [], []
    for r in range(rounds):
        if overlap:
            lag.round()
            install = post(xw[rows])        # the previous round's own slab
            xw = install(ops.sweep_rows_gs(vals_sh, cols_sh, b_sh, xw,
                                           mine[r], beta=beta,
                                           write_base=row0))
        else:
            xw = ops.sweep_rows_gs(vals_sh, cols_sh, b_sh, xw, mine[r],
                                   beta=beta, write_base=row0)
            xw = post(xw[rows])(xw)
        err, resid = metrics(xw) if with_metrics else _no_records(xw)
        errs.append(err)
        resids.append(resid)
    if sync != "allgather" or overlap:
        xw = _all_gather(xw[rows], group, num_workers)
    return xw, errs, resids, None if lag is None else lag.result()


def _banded_split(op, num_workers: int, rank: int):
    """A rank's share of a block-banded operator: (block rows, rows, its
    packed tiles, the halo) with the slab checks of the banded
    strategies."""
    nb = op.nb
    if nb % num_workers:
        raise ValueError(f"worker count ({num_workers}) must divide the "
                         f"block-row count ({nb})")
    nb_local = nb // num_workers
    slab = nb_local * op.block
    blocks = slice(rank * nb_local, (rank + 1) * nb_local)
    rows = slice(rank * slab, (rank + 1) * slab)
    return blocks, rows, op.packed_band_tiles()[blocks], op.halo_width


def _banded_gs(op, b, x0, xs, *, group, rank, num_workers, rounds,
               local_steps, beta, seed, picks, with_metrics):
    """Block-banded slab GS; per-round all-gather of the owned slab.

    The local phase is one ``banded_gs_sweep`` over the rank's
    halo-padded window of its replica (``slab + 2 * bands * block``
    rows), border validity baked into zero tiles, as the reference's
    fused phase.  The records read the gathered replica's window through
    ``banded_window_matvec``: the residual of the rank's rows, and its
    share of e^T A e as the reference groups it,
    ``e_own * (-r + (b - A x*)_own)`` (the last term taken once).
    """
    block, bands = op.block, op.bands
    blocks, rows, Ab_sh, halo = _banded_split(op, num_workers, rank)
    slab = rows.stop - rows.start
    b_sh = b[rows]
    mine = _gs_picks(picks, seed, rounds=rounds, num_workers=num_workers,
                     local_steps=local_steps, hi=slab // block, rank=rank,
                     device=b.device)
    win = slice(rows.start, rows.stop + 2 * halo)

    def window(v):
        return F.pad(v, (0, 0, halo, halo))[win]

    if with_metrics:
        tiles = op.window_tiles(blocks)

        def matvec(v):
            return banded_window_matvec(tiles, window(v), bands=bands,
                                        block=block)

        if xs is not None:
            r_star = b_sh - matvec(xs)

    def metrics(x, own):
        res = b_sh - matvec(x)
        parts = [ops.colsum(res * res)]
        if xs is not None:
            parts.append(ops.colsum((own - xs[rows]) * (-res + r_star)))
        return _records(parts, x, group, num_workers, xs is not None)

    x = x0
    errs, resids = [], []
    for r in range(rounds):
        xw = ops.banded_gs_sweep(Ab_sh, b_sh, window(x), mine[r],
                                 block=block, bands=bands, beta=beta)
        own = xw[halo:halo + slab]
        x = _all_gather(own, group, num_workers)
        err, resid = metrics(x, own) if with_metrics else _no_records(x)
        errs.append(err)
        resids.append(resid)
    return x, errs, resids


def _codec(compress: str):
    """What the wire does to a payload: the codec's f32 round trip."""
    if compress == "bf16":
        return compression.bf16_roundtrip_array
    if compress == "int8_ef":
        return compression.roundtrip_array
    return lambda t: t


def _halo_gs(op, b, x0, xs, *, group, rank, num_workers, rounds,
             local_steps, beta, seed, picks, with_metrics, overlap=False,
             compress="none"):
    """Block-banded slab GS; a neighbor halo exchange in place of the
    all-gather.

    A rank holds only its window: its slab between a halo of
    ``bands * block`` rows a side.  Each round, after the same
    ``banded_gs_sweep`` as ``banded_gs``, it sends its first and last
    ``halo`` owned rows to its neighbors and takes theirs into its halos.
    The ranks form a chain, not a ring: rank 0's low halo and rank P-1's
    high halo stay zero, as the padding does in ``banded_gs``.  The
    gathered entries outside the halo were never read, so the iterates
    are bitwise ``banded_gs``'s.  ``err_sq`` is the window-local A-norm
    error when ``xs`` is given (its halos travel once, exactly, as the
    reference's metrics exchange does), NaN otherwise; the residual is
    summed per panel, then over the panels from left to right, as the
    reference groups it.

    ``compress`` rounds the edges on the wire (no feedback: an edge is
    state, sent fresh every round); ``overlap=True`` sends the edges
    captured at the end of round r-1 while round r's sweep reads halos one
    round staler.
    """
    block, bands = op.block, op.bands
    blocks, rows, Ab_sh, halo = _banded_split(op, num_workers, rank)
    slab = rows.stop - rows.start
    if halo > slab:
        raise ValueError(f"halo exchange needs bands*block <= slab (got "
                         f"{bands}*{block} = {halo} > {slab})")
    nb_local, k = slab // block, b.shape[1]
    b_sh = b[rows]
    mine = _gs_picks(picks, seed, rounds=rounds, num_workers=num_workers,
                     local_steps=local_steps, hi=nb_local, rank=rank,
                     device=b.device)
    wire = _P2P(group)
    codec = _codec(compress)

    def post(lo_edge, hi_edge, *, exact=False):
        """Post my top and bottom owned rows to the neighbors; the
        returned function installs theirs into a window's halos."""
        if not exact:
            lo_edge, hi_edge = codec(lo_edge), codec(hi_edge)
        sends, got = [], []
        if rank > 0:
            sends.append((rank - 1, lo_edge))
            got.append((rank - 1, slice(0, halo)))
        if rank < num_workers - 1:
            sends.append((rank + 1, hi_edge))
            got.append((rank + 1, slice(halo + slab, 2 * halo + slab)))
        bufs = {peer: torch.empty_like(lo_edge) for peer, _ in got}
        landed = wire.post(sends, list(bufs.items()))

        def install(vw):
            landed()
            for peer, where in got:
                vw[where] = bufs[peer]
            return vw
        return install

    def exchange(vw, *, exact=False):
        own = vw[halo:halo + slab]
        return post(own[:halo], own[slab - halo:], exact=exact)(vw)

    def padded(v):
        return F.pad(v[rows], (0, 0, halo, halo))

    if with_metrics:
        tiles = op.window_tiles(blocks)

        def matvec(vw):
            return banded_window_matvec(tiles, vw, bands=bands, block=block)

        if xs is not None:
            xs_w = exchange(padded(xs), exact=True)

    def metrics(xw):
        res = b_sh - matvec(xw)
        sq = (res * res).view(nb_local, block, k).transpose(0, 1)
        panels = ops.colsum(sq.contiguous().view(block, nb_local * k)).view(
            nb_local, k)
        rsq = panels[0]
        for p in range(1, nb_local):
            rsq = rsq + panels[p]
        parts = [rsq]
        if xs is not None:
            ew = xw - xs_w
            parts.append(ops.colsum(ew[halo:halo + slab] * matvec(ew)))
        return _records(parts, xw, group, num_workers, xs is not None)

    lag = _Lag(group, rank, num_workers, local_steps, b.device) if overlap \
        else None
    xw = exchange(padded(x0))
    errs, resids = [], []
    for r in range(rounds):
        if overlap:
            lag.round()
            own = xw[halo:halo + slab]
            install = post(own[:halo], own[slab - halo:])
            xw = install(ops.banded_gs_sweep(Ab_sh, b_sh, xw, mine[r],
                                             block=block, bands=bands,
                                             beta=beta))
        else:
            xw = exchange(ops.banded_gs_sweep(Ab_sh, b_sh, xw, mine[r],
                                              block=block, bands=bands,
                                              beta=beta))
        err, resid = metrics(xw) if with_metrics else _no_records(xw)
        errs.append(err)
        resids.append(resid)
    x = _all_gather(xw[halo:halo + slab], group, num_workers)
    return x, errs, resids, None if lag is None else lag.result()


def _dense_gs(op, b, x0, xs, *, block, group, rank, num_workers, rounds,
              local_steps, beta, seed, picks, with_metrics):
    """Dense slab-partitioned block GS; all-gather of the owned slabs.

    The local phase is ONE ``block_gs_sweep`` launch per round on the
    rank's working replica, its ids the global ids of the rank's blocks
    (``rank * slab / block + pick``): each step is
    ``x[B] += beta * (b[B] - A[B, :] @ x)`` with the rank's own rows fresh
    and the others' as of the round's start.  The reference has no fused
    dense local phase: its scan keeps the round's delta apart,
    ``g = b[B] - A[B, :] @ x - A[B, own] @ delta``, and adds it once at
    the round's end.  ``x + embed(delta)`` is this working replica, so
    the two compute the same function; the port sums the two products as
    one and adds each step into x, so it agrees with the reference within
    a tolerance, not bitwise.  The records are the A-norm error and the
    residual of the rank's rows, through ``DenseOp.matvec``'s 64-column
    groups, so that a column's records do not depend on k.
    """
    A = op.A
    n = A.shape[0]
    if n % num_workers or (n // num_workers) % block:
        raise ValueError(f"worker count ({num_workers}) times the block "
                         f"({block}) must divide the row count ({n})")
    slab = n // num_workers
    rows = slice(rank * slab, (rank + 1) * slab)
    per_rank = slab // block
    mine = _gs_picks(picks, seed, rounds=rounds, num_workers=num_workers,
                     local_steps=local_steps, hi=per_rank, rank=rank,
                     device=b.device) + rank * per_rank
    own_rows = DenseOp(A[rows])
    b_sh = b[rows]

    def metrics(x):
        res = b_sh - own_rows.matvec(x)
        parts = [ops.colsum(res * res)]
        if xs is not None:
            e = x - xs
            parts.append(ops.colsum(e[rows] * own_rows.matvec(e)))
        return _records(parts, x, group, num_workers, xs is not None)

    x = x0
    errs, resids = [], []
    for r in range(rounds):
        xw = ops.block_gs_sweep(A, b, x, mine[r], block=block, beta=beta)
        x = _all_gather(xw[rows], group, num_workers)
        err, resid = metrics(x) if with_metrics else _no_records(x)
        errs.append(err)
        resids.append(resid)
    return x, errs, resids


class _DeltaSync:
    """The Kaczmarz delta exchange of one solve: ``post(delta)`` starts
    it, ``apply(x, posted, delta)`` finishes it and returns
    ``x + (S - delta)`` on the column slabs the rank holds, S the sum of
    every rank's delta added in rank order (the module's docstring).
    ``need`` (a2a) is the column-slab graph; None is the psum (every slab
    to every rank).  ``assemble(x)`` is the returned iterate."""

    def __init__(self, n: int, group, rank: int, num_workers: int,
                 need=None):
        self.group, self.rank, self.P, self.need = (group, rank, num_workers,
                                                    need)
        self.cs = n // num_workers if n % num_workers == 0 else None
        self.wire = _P2P(group)
        P = num_workers
        full = np.ones((P, P), bool) if need is None else need
        self.owners = [c for c in range(P) if c != rank and full[rank, c]]
        self.contributors = [v for v in range(P)
                             if v != rank and full[v, rank]]
        self.readers = [w for w in range(P) if w != rank and full[w, rank]]

    def _slab(self, t: torch.Tensor, c: int) -> torch.Tensor:
        return t[c * self.cs:(c + 1) * self.cs]

    def post(self, delta: torch.Tensor):
        if self.P == 1:
            return None
        if self.cs is None:
            return _post_all_gather(delta, self.group, self.P)
        own = self._slab(delta, self.rank)
        terms = {v: torch.empty_like(own) for v in self.contributors}
        landed = self.wire.post(
            [(c, self._slab(delta, c)) for c in self.owners],
            list(terms.items()))
        return landed, terms

    def apply(self, x: torch.Tensor, posted, delta: torch.Tensor):
        if self.P == 1:
            return x
        if self.cs is None:
            parts = posted().view(self.P, *delta.shape)
            total = parts[0]
            for v in range(1, self.P):
                total = total + parts[v]
            return x + (total - delta)
        landed, terms = posted
        landed()
        own = self._slab(delta, self.rank)
        terms[self.rank] = own
        zero = None
        total = None
        for v in range(self.P):       # rank order, an exact zero for a
            t = terms.get(v)          # rank that never touches the slab
            if t is None:
                zero = torch.zeros_like(own) if zero is None else zero
                t = zero
            total = t if total is None else total + t
        if self.need is None:
            return x + (_all_gather(total, self.group, self.P) - delta)
        x = x.clone()
        mine = self._slab(x, self.rank)
        mine.copy_(mine + (total - own))
        sums = {c: torch.empty_like(own) for c in self.owners}
        self.wire.exchange([(w, total) for w in self.readers],
                           list(sums.items()))
        for c, s in sums.items():
            cur = self._slab(x, c)
            cur.copy_(cur + (s - self._slab(delta, c)))
        return x

    def assemble(self, x: torch.Tensor) -> torch.Tensor:
        """The owners' column slabs, gathered: the same on every rank
        (the calling rank's replica where P does not divide n)."""
        if self.P == 1 or self.cs is None:
            return x
        return _all_gather(self._slab(x, self.rank), self.group, self.P)


def _sparse_rk(op, b, x0, xs, *, group, rank, num_workers, rounds,
               local_steps, beta, seed, picks, with_metrics=True, need=None,
               overlap=False, compress="none"):
    """Row-sparse Kaczmarz with per-rank LOCAL sampling (CsrOp / EllOp).

    Each rank samples its ``local_steps`` rows ∝ its own slab's row norms,
    so every step is a useful update; the round-level interleaving of the
    P local streams is a shared stream of ``P * local_steps`` picks, hence
    ``tau = P * local_steps - 1``.  All-zero slabs are safe: the picks
    fall back to uniform and ``rn_safe`` divides the zero rows' (zero)
    residuals by 1.  The error is the rank's column slab of the iterate
    (always fresh), summed over the ranks; the residual is the rank's rows,
    summed over the ranks.  The delta sum is ``_DeltaSync``'s (``need``:
    the a2a column-slab graph, None for the psum).

    ``overlap=True`` sends the delta accumulated in round r-1 while round
    r's sweep accumulates a fresh one, and flushes the last round's delta
    with one trailing exchange.  ``compress`` sends every delta as the
    codec's round trip and applies ``S(sent) - sent``: a rank's own
    updates stay exact; ``int8_ef`` quantizes ``delta + residual`` and
    keeps the quantization error as the next residual, flushed exactly
    after the last round (after the overlap flush).  P = 1 has nothing to
    compress.
    """
    m, k = b.shape
    n = x0.shape[0]
    if m % num_workers:
        raise ValueError(
            f"worker count ({num_workers}) must divide the row count ({m})")
    slab = m // num_workers
    rows = slice(rank * slab, (rank + 1) * slab)
    vals, cols = op.padded_rows()
    vals_sh, cols_sh = vals[rows], cols[rows]
    counts = op.stop_counts(k)
    counts_sh = None if counts is None else counts[rows]
    b_sh = b[rows]
    rn_sh = op.row_norms_sq()[rows]
    rn_safe = torch.where(rn_sh > 0, rn_sh, 1.0)
    if picks is None:
        gen = torch.Generator(device=b.device).manual_seed(
            seed * num_workers + rank)
        mine = sample_rows(rn_sh, rounds * local_steps,
                           generator=gen).reshape(rounds, local_steps)
    else:
        mine = _caller_picks(picks, (rounds, num_workers, local_steps), slab,
                             b.device)[:, rank]
    cs = n // num_workers if n % num_workers == 0 else None
    cols_own = slice(rank * cs, (rank + 1) * cs) if cs is not None else None
    if num_workers == 1:
        compress = "none"
    sync = _DeltaSync(n, group, rank, num_workers, need)

    def metrics(x):
        r = b_sh - ops.spmv_ell(vals_sh, cols_sh, x, n_cols=n,
                                counts=counts_sh)
        parts = [ops.colsum(r * r)]
        if xs is not None and cs is not None:
            e = x[cols_own] - xs[cols_own]
            parts.append(ops.colsum(e * e))
        tot = _all_reduce(torch.stack(parts), group, num_workers)
        if xs is None:
            err = _nan_err(x)
        elif cs is None:
            err = ops.colsum((x - xs) * (x - xs))
        else:
            err = tot[1]
        return err, torch.sqrt(tot[0])

    def sweep(x, r):
        return ops.sweep_rows_rk_delta(vals_sh, cols_sh, b_sh, rn_safe, x,
                                       torch.zeros_like(x), mine[r],
                                       beta=beta)

    x, errs, resids, lag = _rk_rounds(
        sweep, metrics, sync, x0, rounds=rounds, overlap=overlap,
        compress=compress, with_metrics=with_metrics,
        lag=_Lag(group, rank, num_workers, local_steps, b.device)
        if overlap else None)
    return sync.assemble(x), errs, resids, lag


def _rk_rounds(sweep, metrics, sync, x0, *, rounds, overlap, compress,
               with_metrics, lag):
    """The round loop of a Kaczmarz strategy: ``sweep(x, r)`` is the
    local phase (new x and the round's delta), ``sync`` the delta
    exchange; lockstep or overlapped, through the codec, with the
    error-feedback residual and the trailing flushes."""
    codec = _codec(compress)
    use_ef = compress == "int8_ef"
    resid = torch.zeros_like(x0) if use_ef else None

    def wire(payload):
        nonlocal resid
        if use_ef:
            corrected = payload + resid
            sent = codec(corrected)
            resid = corrected - sent
            return sent
        return codec(payload)

    x = x0
    dprev = torch.zeros_like(x0) if overlap else None
    errs, resids = [], []
    for r in range(rounds):
        if overlap:
            lag.round()
            sent = wire(dprev)
            posted = sync.post(sent)          # the previous round's delta
            x, dprev = sweep(x, r)
            x = sync.apply(x, posted, sent)
        else:
            x, delta = sweep(x, r)
            sent = wire(delta)
            x = sync.apply(x, sync.post(sent), sent)
        err, res = metrics(x) if with_metrics else _no_records(x)
        errs.append(err)
        resids.append(res)
    if overlap:
        # the last round's delta (with, under EF, the outstanding
        # residual) in one exact trailing exchange
        last = dprev + resid if use_ef else dprev
        x = sync.apply(x, sync.post(last), last)
    elif use_ef:
        x = sync.apply(x, sync.post(resid), resid)
    return x, errs, resids, None if lag is None else lag.result()


def _dense_rk(op, b, x0, xs, *, group, rank, num_workers, rounds,
              local_steps, beta, seed, picks, with_metrics=True):
    """Row-slab Kaczmarz on the dense format: one global i.i.d. stream of
    rows sampled ∝ their norms (the same on every rank), partitioned by
    owner; the delta sum at the round's end (``tau = local_steps - 1``).

    Every rank runs the whole stream in ONE ``sweep_rows_rk_delta`` launch
    a round over its slab of rows as windows of width n (column ids
    ``arange(n)``) and one all-zero row (b 0, rn 1) that every pick it
    does not own is mapped onto: such a step reads its window, adds exact
    zeros and writes nothing else, as the reference's masked step
    ``where(mine, beta, 0) * A_r * g`` does.  The residual is the rank's
    rows through ``DenseOp.matvec``, summed over the ranks; the error is
    the whole replica's.
    """
    A = op.A
    m, n = A.shape
    k = b.shape[1]
    if m % num_workers:
        raise ValueError(
            f"worker count ({num_workers}) must divide the row count ({m})")
    slab = m // num_workers
    row0 = rank * slab
    rows = slice(row0, row0 + slab)
    rn = op.row_norms_sq()
    if picks is None:
        gen = torch.Generator(device=b.device).manual_seed(seed)
        picks = sample_rows(rn, rounds * local_steps,
                            generator=gen).reshape(rounds, local_steps)
    else:
        picks = _caller_picks(picks, (rounds, local_steps), m, b.device)
    li = picks - row0
    local = torch.where((li >= 0) & (li < slab), li, slab).to(
        torch.int32).contiguous()
    zero_row = torch.zeros((1, n), dtype=A.dtype, device=A.device)
    vals_sh = torch.cat([A[rows], zero_row])
    cols_sh = torch.arange(n, dtype=_index_dtype(A.dtype, n),
                           device=A.device).expand(slab + 1, n).contiguous()
    b_sh = b[rows]
    b_z = torch.cat([b_sh, b.new_zeros((1, k))])
    rn_sh = rn[rows]
    rn_z = torch.cat([torch.where(rn_sh > 0, rn_sh, 1.0),
                      rn.new_ones((1,))])
    own_rows = DenseOp(A[rows])

    def metrics(x):
        res = b_sh - own_rows.matvec(x)
        rsq = _all_reduce(ops.colsum(res * res), group, num_workers)
        err = (_nan_err(x) if xs is None
               else ops.colsum((x - xs) * (x - xs)))
        return err, torch.sqrt(rsq)

    def sweep(x, r):
        return ops.sweep_rows_rk_delta(vals_sh, cols_sh, b_z, rn_z, x,
                                       torch.zeros_like(x), local[r],
                                       beta=beta)

    sync = _DeltaSync(n, group, rank, num_workers)
    x, errs, resids, _ = _rk_rounds(
        sweep, metrics, sync, x0, rounds=rounds, overlap=False,
        compress="none", with_metrics=with_metrics, lag=None)
    return sync.assemble(x), errs, resids


def _banded_rk(op, b, x0, xs, *, group, rank, num_workers, rounds,
               local_steps, beta, seed, picks, with_metrics=True):
    """Block-banded Kaczmarz: one global stream of block rows sampled ∝
    their squared Frobenius norms, partitioned by owner.

    The panel update is the damped simultaneous-row (Cimmino-within-panel)
    action ``x += beta * A_B^T diag(1/||a_i||^2) (b - A x)_B``, whose
    writes reach ``bands`` block columns either side of the panel.  Each
    rank runs the whole stream in its kernel over the halo-padded windows
    of its replica and of the round delta, ``slab + 2 * bands * block``
    rows: a pick it does not own (gate 0) does the same reads and adds
    exact zeros, as the reference's masked arithmetic does, so
    ``tau = local_steps - 1``.  The delta sum is ``_DeltaSync``'s psum.
    The residual is the rank's rows of ``bbmv(x)``, summed over the ranks;
    the error is the whole replica's.
    """
    block, bands, nb = op.block, op.bands, op.nb
    n, k = b.shape
    if nb % num_workers:
        raise ValueError(f"worker count ({num_workers}) must divide the "
                         f"block-row count ({nb})")
    nb_local = nb // num_workers
    slab = nb_local * block
    halo = bands * block
    rn = op.row_norms_sq()                                  # (nb, block)
    panel_w = rn.sum(1)             # raw: a zero panel keeps weight 0
    rn = torch.where(rn > 0, rn, 1.0)                       # divisor guard
    if picks is None:
        gen = torch.Generator(device=b.device).manual_seed(seed)
        picks = sample_rows(panel_w, rounds * local_steps,
                            generator=gen).reshape(rounds, local_steps)
    else:
        picks = _caller_picks(picks, (rounds, local_steps), nb, b.device)
    li = picks - rank * nb_local
    gates = ((li >= 0) & (li < nb_local)).to(torch.int32)
    lic = li.clamp(0, nb_local - 1)
    blocks = slice(rank * nb_local, (rank + 1) * nb_local)
    Ab_sh = op.packed_band_tiles()[blocks]
    rn_sh = rn[blocks]
    row0 = rank * slab
    b_sh = b[row0:row0 + slab]
    win = slice(row0, row0 + slab + 2 * halo)

    def sweep(x, r):
        xpad = F.pad(x, (0, 0, halo, halo))
        xwin, dwin = ops.banded_rk_sweep(
            Ab_sh, b_sh, rn_sh, xpad[win], torch.zeros_like(xpad[win]),
            lic[r], gates[r], block=block, bands=bands, beta=beta)
        xpad[win] = xwin
        dpad = torch.zeros_like(xpad)
        dpad[win] = dwin
        return xpad[halo:halo + n], dpad[halo:halo + n]

    def metrics(x):
        res = b_sh - op.matvec(x)[row0:row0 + slab]
        resid = torch.sqrt(_all_reduce(ops.colsum(res * res), group,
                                       num_workers))
        err = (_nan_err(x) if xs is None
               else ops.colsum((x - xs) * (x - xs)))
        return err, resid

    sync = _DeltaSync(n, group, rank, num_workers)
    x, errs, resids, _ = _rk_rounds(
        sweep, metrics, sync, x0, rounds=rounds, overlap=False,
        compress="none", with_metrics=with_metrics, lag=None)
    return sync.assemble(x), errs, resids
