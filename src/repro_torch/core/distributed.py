"""The distributed engine on ``torch.distributed`` (port of the distributed
section of ``repro/core/engine.py``: ``solve_distributed`` with its
Gauss-Seidel strategies, and its Kaczmarz strategies under the delta
all-reduce).

SPMD, as ``shard_map`` is: every rank of the process group calls
``solve_distributed`` with the whole problem and takes its own slab of
rows (what the reference's ``in_specs`` do).  Rounds run in lockstep: a
round is one local phase of ``local_steps`` updates, then the round's
exchange, then the records (zeros with ``with_metrics=False``, and no
record collective).  At P = 1 no collective runs.

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
  ``banded_rk_sweep``.

The records' products go through the port's kernels (``spmv_ell`` over
the rank's row windows, ``bbmv``, ``colsum``; a dense slab's rows through
``torch.matmul`` in ``DenseOp.matvec``'s 64-column groups), so on the card
no plain version runs.

Exchanges.  GS: the all-gather of the owned slabs (``dist.all_gather``,
list form); the neighbor all-to-all of ``sparse_gs`` (``sync="a2a"``: one
rotation per distinct slab offset of the operator's ``slab_neighbors``
graph, a rank's slab sent only to the ranks whose rows read it, never
over the rank's own slab; all-gather where every rank reads every slab);
and the halo exchange of ``halo_gs`` (two edges of ``bands * block`` rows
to the neighbors of a chain).  RK: the delta all-reduce.  Point-to-point
payloads go through ``dist.batch_isend_irecv`` (``_P2P``).  gloo's send
and receive hand a tensor's address to its TCP transport, which reads and
writes host memory, so a payload on the card is staged, explicitly,
through a pinned host buffer reused for the whole solve; compute stays on
the card.

Strategies (``_DISTRIBUTED_STRATEGIES``): the reference's GS rows, and its
RK rows under the psum.  Not yet (ROADMAP queue 1 item 8): the RK a2a
exchange (which ``sync="auto"`` picks for CSR/ELL, as in the reference),
``dense_rk``, ``overlap``, ``compress`` and ``partition="balanced"``.

Pick streams: ``picks=`` overrides them; otherwise they are drawn with a
``torch.Generator`` (a different stream from the reference's threefry
key).  The GS strategies draw each rank's ``(rounds, local_steps)``
slab-local ids (rows, blocks of ``block`` rows, or block rows) uniformly
from ``seed * P + rank``, where the reference draws
``randint(fold_in(split(key, rounds)[r], rank))``; ``banded_rk`` draws
one global stream of block rows ∝ panel norms, the same on every rank,
from ``seed``; ``sparse_rk`` draws each rank's rows ∝ its slab's row
norms from ``seed * P + rank`` (the counterpart of ``fold_in(key,
rank)``).

The result's ``x``: the GS strategies return the assembled global
iterate, each slab from its owner (the last round's all-gather, or one
more all-gather under ``a2a`` and ``halo``, where a rank's replica holds
stale remote slabs or only its window), bitwise the same on every rank,
as the reference assembles it through its ``out_specs``.  The RK
strategies return the calling rank's replica; replicas agree to the last
bits only (each rank applied its own updates in its kernel and the
others' through the sum).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.engine import (ParallelSolveResult, sample_rows,
                                     scheduled_tau)
from repro_torch.core.operators import (CsrOp, DenseOp, EllOp,
                                        banded_window_matvec)
from repro_torch.kernels import ops

#: action x format x sync -> strategy, the rows of the reference's table
#: (``repro/core/engine.py``) that the port has.
_DISTRIBUTED_STRATEGIES = {
    ("gs", "DenseOp", "allgather"): "dense_gs",
    ("gs", "BlockBandedOp", "allgather"): "banded_gs",
    ("gs", "BlockBandedOp", "halo"): "halo_gs",
    ("gs", "EllOp", "allgather"): "sparse_gs",
    ("gs", "EllOp", "a2a"): "sparse_gs",
    ("gs", "CsrOp", "allgather"): "sparse_gs",
    ("gs", "CsrOp", "a2a"): "sparse_gs",
    ("rk", "BlockBandedOp", "psum"): "banded_rk",
    ("rk", "CsrOp", "psum"): "sparse_rk",
    ("rk", "EllOp", "psum"): "sparse_rk",
}

#: the reference's rows that the port lacks, and what each is there
_NOT_PORTED = {("rk", "DenseOp", "psum"): "dense_rk"}

_LEFT = ("not ported yet (ROADMAP queue 1 item 8, with the rest of the "
         "reference's distributed engine: the RK a2a exchange, dense_rk, "
         "overlap, compress and partition='balanced')")


def _sync_bytes_per_round(kind: str, *, n: int, k: int, num_workers: int,
                          sync: str | None = None, halo: int = 0,
                          a2a_schedule=()) -> float:
    """Analytic per-round sync payload: bytes ONE rank sends per round,
    f32 (the compressed wires come with ``compress``, not ported yet).
    ``halo`` is ``bands * block`` of ``halo_gs``; under the a2a exchange
    the sends vary with the neighbor graph, so their total over the ranks
    is averaged over P.  At P = 1 no collective runs: 0 bytes."""
    if num_workers <= 1:
        return 0.0
    slab = n // num_workers
    if kind in ("dense_gs", "banded_gs"):
        return 4.0 * slab * k                      # all-gather of the slab
    if kind == "halo_gs":
        return 2.0 * (4.0 * (halo * k))            # two edges
    if kind == "sparse_gs":
        if sync == "a2a":
            sends = sum(len(pairs) for _, pairs in a2a_schedule)
            return 4.0 * slab * k * sends / num_workers
        return 4.0 * slab * k                      # all-gather of the slab
    if kind in ("banded_rk", "sparse_rk"):
        return 4.0 * n * k                         # full-delta all-reduce
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


def _all_reduce(t: torch.Tensor, group, num_workers: int) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor); ``t`` itself at
    P = 1, where no collective runs."""
    if num_workers == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(own: torch.Tensor, group, num_workers: int) -> torch.Tensor:
    """Every rank's ``own`` slab stacked in rank order (a new tensor, the
    same on every rank); ``own`` itself at P = 1."""
    if num_workers == 1:
        return own
    parts = [torch.empty_like(own) for _ in range(num_workers)]
    dist.all_gather(parts, own, group=group)
    return torch.cat(parts, 0)


class _P2P:
    """The point-to-point exchanges of one solve on ``group``.

    ``exchange`` posts a round's sends and receives in one
    ``dist.batch_isend_irecv`` and waits for them.  A tensor on the card
    travels through a pinned host buffer (gloo's TCP transport reads and
    writes host memory): one buffer per distinct payload sent and per
    peer received from, allocated at first use and reused for the whole
    solve.  The copies are synchronous, so a buffer is free again when
    ``exchange`` returns.
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

    def exchange(self, sends, recvs) -> None:
        """``sends``: (peer, tensor) pairs; ``recvs``: (peer, out) pairs,
        each ``out`` (a contiguous tensor, a view too) filled with what its
        peer sent.  Peers are ranks of the group; between two ranks at
        most one payload travels each way."""
        p2p, landed, staged = [], [], {}
        for peer, t in sends:
            buf = staged.get(id(t))
            if buf is None:
                buf = self._staging(("send", len(staged)), t)
                if buf is None:
                    buf = t
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
        if p2p:
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        for buf, out in landed:
            out.copy_(buf)

    def _global(self, peer: int) -> int:
        return dist.get_global_rank(self.group, peer)


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
) -> ParallelSolveResult:
    """P-way solve under the periodic-synchronization schedule; call it on
    every rank of ``group`` with the same arguments.

    ``sync="auto"`` resolves as the reference's rule does: Kaczmarz takes
    the a2a exchange on CSR/ELL (not ported yet: it raises and names
    ``sync="psum"``, whose iterates the reference pins bitwise to a2a's)
    and the psum elsewhere; GS takes the halo exchange where the operator
    has a finite ``halo_width`` (block-banded), the a2a exchange where it
    answers ``slab_neighbors`` (CSR, ELL) and the all-gather elsewhere
    (dense).  ``block`` is the dense block-GS granularity (``gs_block``;
    the sparse slab strategies run coordinate GS and refuse another).
    ``picks`` (else ``seed``) gives the streams: ``(rounds, P,
    local_steps)`` slab-local ids for the GS strategies (rows, blocks of
    ``block`` rows, block rows) and ``sparse_rk``, ``(rounds,
    local_steps)`` global block-row ids for ``banded_rk``.  With
    ``with_metrics=False`` the records are zeros and cost nothing.
    ``x0`` is not modified.
    """
    if rounds <= 0 or local_steps <= 0:
        raise ValueError(f"need rounds > 0 and local_steps > 0 (got "
                         f"{rounds}, {local_steps})")
    num_workers = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if sync == "auto":
        if action == "rk":
            sync = "a2a" if hasattr(op, "slab_neighbors") else "psum"
        elif op.halo_width is not None:
            sync = "halo"
        elif hasattr(op, "slab_neighbors"):
            sync = "a2a"
        else:
            sync = "allgather"
    row = (action, type(op).__name__, sync)
    kind = _DISTRIBUTED_STRATEGIES.get(row)
    if kind is None:
        if action == "rk" and sync == "a2a" and isinstance(op, (CsrOp, EllOp)):
            raise NotImplementedError(
                f"the a2a delta exchange of Kaczmarz on {type(op).__name__} "
                f"(the reference's sync='auto' choice there) is {_LEFT}; "
                "pass sync='psum', whose iterates the reference pins "
                "bitwise to a2a's")
        missing = (f" (the reference's {_NOT_PORTED[row]} is {_LEFT})"
                   if row in _NOT_PORTED else "")
        supported = "\n  ".join(
            f"action={a!r} x format={f} x sync={s!r}"
            for (a, f, s) in sorted(_DISTRIBUTED_STRATEGIES))
        raise NotImplementedError(
            f"no distributed strategy for action={action!r}, "
            f"format={type(op).__name__}, sync={sync!r}{missing}; supported "
            f"combinations:\n  {supported}")
    if kind == "sparse_gs" and block != 1:
        raise NotImplementedError(
            f"distributed block GS with block={block} is not supported for "
            f"{type(op).__name__}; the sparse slab strategies run "
            "coordinate GS (block=1)")
    if picks is None and seed is None:
        raise ValueError("solve_distributed needs a seed or picks")
    n, k = x0.shape[0], b.shape[1]
    common = dict(group=group, rank=rank, num_workers=num_workers,
                  rounds=rounds, local_steps=local_steps, beta=beta,
                  seed=seed, picks=picks, with_metrics=with_metrics)
    schedule = ()
    if kind == "sparse_gs":
        masks = None
        if sync == "a2a":
            need = op.slab_neighbors(num_workers)
            if num_workers > 1 and bool(need.all()):
                # Every rank reads every slab: the rotations would move the
                # all-gather's bytes over P - 1 exchanges; one all-gather.
                sync = "allgather"
            else:
                schedule, masks = _a2a_plan(need, num_workers)
        x, errs, resids = _sparse_gs(op, b, x0, x_star, sync=sync,
                                     a2a_schedule=schedule, a2a_masks=masks,
                                     **common)
    elif kind == "banded_gs":
        x, errs, resids = _banded_gs(op, b, x0, x_star, **common)
    elif kind == "halo_gs":
        x, errs, resids = _halo_gs(op, b, x0, x_star, **common)
    elif kind == "dense_gs":
        x, errs, resids = _dense_gs(op, b, x0, x_star, block=block, **common)
    elif kind == "sparse_rk":
        x, errs, resids = _sparse_rk(op, b, x0, x_star, **common)
    else:
        x, errs, resids = _banded_rk(op, b, x0, x_star, **common)
    if kind.endswith("_gs"):
        tau = scheduled_tau(num_workers, local_steps, shared_stream=False)
    else:
        tau = scheduled_tau(num_workers, local_steps, shared_stream=True,
                            local_sampling=kind == "sparse_rk")
    return ParallelSolveResult(
        x=x, err_sq=torch.stack(errs), resid=torch.stack(resids), tau=tau,
        bytes_per_round=_sync_bytes_per_round(
            kind, n=n, k=k, num_workers=num_workers, sync=sync,
            halo=op.halo_width or 0,
            a2a_schedule=schedule))


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
               a2a_schedule, a2a_masks):
    """Row-sparse slab GS (CsrOp / EllOp), the format-generic strategy.

    Each rank owns a slab of rows in padded-row form (fixed-width windows
    with global column ids, ``op.padded_rows()``), keeps a full-length
    working replica whose own slab is fresh within a round, and refreshes
    it at the round's end by the all-gather or by the neighbor exchange
    (``sync="a2a"``): a rank receives only the slabs its rows read, over
    the masked rotations of ``a2a_schedule``.  The slabs a2a leaves stale
    are never read (a padding slot's column is the row's own under ELL,
    column 0 with value 0 under CSR: an exact zero either way), so the
    iterates and records are bitwise the all-gather's.  The records read
    only the rank's rows: its squared residual and its share of
    e^T A e, summed over the ranks.
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

    def refresh(xw):
        if sync == "allgather":
            return _all_gather(xw[rows], group, num_workers)
        own, sends, recvs = xw[rows], [], []
        for i, (shift, pairs) in enumerate(a2a_schedule):
            dst = (rank + shift) % num_workers
            if (rank, dst) in pairs:
                sends.append((dst, own))
            if a2a_masks[rank, i]:
                src = (rank - shift) % num_workers
                recvs.append((src, xw[src * slab:(src + 1) * slab]))
        wire.exchange(sends, recvs)
        return xw

    def matvec(v):
        return ops.spmv_ell(vals_sh, cols_sh, v, n_cols=n, counts=counts_sh)

    def metrics(xw):
        res = b_sh - matvec(xw)
        parts = [ops.colsum(res * res)]
        if xs is not None:
            e = xw - xs
            parts.append(ops.colsum(e[rows] * matvec(e)))
        return _records(parts, xw, group, num_workers, xs is not None)

    xw = x0
    errs, resids = [], []
    for r in range(rounds):
        xw = refresh(ops.sweep_rows_gs(vals_sh, cols_sh, b_sh, xw, mine[r],
                                       beta=beta, write_base=row0))
        err, resid = metrics(xw) if with_metrics else _no_records(xw)
        errs.append(err)
        resids.append(resid)
    if sync != "allgather":
        xw = _all_gather(xw[rows], group, num_workers)
    return xw, errs, resids


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


def _halo_gs(op, b, x0, xs, *, group, rank, num_workers, rounds,
             local_steps, beta, seed, picks, with_metrics):
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

    def exchange(vw):
        own, sends, recvs = vw[halo:halo + slab], [], []
        if rank > 0:
            sends.append((rank - 1, own[:halo]))
            recvs.append((rank - 1, vw[:halo]))
        if rank < num_workers - 1:
            sends.append((rank + 1, own[slab - halo:]))
            recvs.append((rank + 1, vw[halo + slab:]))
        wire.exchange(sends, recvs)
        return vw

    def padded(v):
        return F.pad(v[rows], (0, 0, halo, halo))

    if with_metrics:
        tiles = op.window_tiles(blocks)

        def matvec(vw):
            return banded_window_matvec(tiles, vw, bands=bands, block=block)

        if xs is not None:
            xs_w = exchange(padded(xs))
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

    xw = exchange(padded(x0))
    errs, resids = [], []
    for r in range(rounds):
        xw = exchange(ops.banded_gs_sweep(Ab_sh, b_sh, xw, mine[r],
                                          block=block, bands=bands,
                                          beta=beta))
        err, resid = metrics(xw) if with_metrics else _no_records(xw)
        errs.append(err)
        resids.append(resid)
    x = _all_gather(xw[halo:halo + slab], group, num_workers)
    return x, errs, resids


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


def _sparse_rk(op, b, x0, xs, *, group, rank, num_workers, rounds,
               local_steps, beta, seed, picks, with_metrics=True):
    """Row-sparse Kaczmarz with per-rank LOCAL sampling (CsrOp / EllOp).

    Each rank samples its ``local_steps`` rows ∝ its own slab's row norms,
    so every step is a useful update; the round-level interleaving of the
    P local streams is a shared stream of ``P * local_steps`` picks, hence
    ``tau = P * local_steps - 1``.  All-zero slabs are safe: the picks
    fall back to uniform and ``rn_safe`` divides the zero rows' (zero)
    residuals by 1.  The error is the rank's column slab of the iterate
    (always fresh), summed over the ranks; the residual is the rank's rows,
    summed over the ranks.
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

    x = x0
    errs, resids = [], []
    for r in range(rounds):
        x, delta = ops.sweep_rows_rk_delta(vals_sh, cols_sh, b_sh, rn_safe, x,
                                           torch.zeros_like(x), mine[r],
                                           beta=beta)
        if num_workers > 1:
            x = x + (_all_reduce(delta, group, num_workers) - delta)
        err, resid = metrics(x) if with_metrics else _no_records(x)
        errs.append(err)
        resids.append(resid)
    return x, errs, resids


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
    ``tau = local_steps - 1``.  The residual is the rank's rows of
    ``bbmv(x)``, summed over the ranks; the error is the whole replica's.
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

    x = x0
    errs, resids = [], []
    for r in range(rounds):
        xpad = F.pad(x, (0, 0, halo, halo))
        xwin, dwin = ops.banded_rk_sweep(
            Ab_sh, b_sh, rn_sh, xpad[win], torch.zeros_like(xpad[win]),
            lic[r], gates[r], block=block, bands=bands, beta=beta)
        xpad[win] = xwin
        x = xpad[halo:halo + n]
        if num_workers > 1:
            dpad = torch.zeros_like(xpad)
            dpad[win] = dwin
            delta = dpad[halo:halo + n]
            x = x + (_all_reduce(delta, group, num_workers) - delta)
        if not with_metrics:
            err, resid = _no_records(x)
        else:
            res = b_sh - op.matvec(x)[row0:row0 + slab]
            resid = torch.sqrt(_all_reduce(ops.colsum(res * res), group,
                                           num_workers))
            err = (_nan_err(x) if xs is None
                   else ops.colsum((x - xs) * (x - xs)))
        errs.append(err)
        resids.append(resid)
    return x, errs, resids
