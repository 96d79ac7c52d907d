"""The distributed engine on ``torch.distributed`` (port of the distributed
section of ``repro/core/engine.py``, ``solve_distributed`` and its
Kaczmarz strategies under the delta all-reduce).

SPMD, as ``shard_map`` is: every rank of the process group calls
``solve_distributed`` with the whole problem and takes its own slab of
rows (what the reference's ``in_specs`` do).  A round is one local phase
of ``local_steps`` Kaczmarz updates on the rank's replica of the iterate,
accumulated also into a round delta; then the deltas are summed over the
ranks (``all_reduce``, the reference's ``psum``) and each rank adds the
others' share, ``x + (all_reduce(delta) - delta)``; then the metrics.  At
P = 1 no collective runs.

The local phase is ONE kernel launch per round per rank on the card (the
fused local phase; the reference's per-step scan is not ported, as in the
sequential engine): ``sweep_rows_rk_delta`` for ``sparse_rk`` (CSR and
ELL), ``banded_rk_sweep`` for ``banded_rk``.  The metrics' A·x goes
through the port's matvec kernels (``spmv_ell`` over the rank's row
windows, ``bbmv``), so on the card no plain version runs.

Strategies ported (``_DISTRIBUTED_STRATEGIES``): ``("rk", "CsrOp",
"psum")`` and ``("rk", "EllOp", "psum")`` -> ``sparse_rk``, ``("rk",
"BlockBandedOp", "psum")`` -> ``banded_rk``.  Not yet: the RK a2a
exchange (which ``sync="auto"`` picks for CSR/ELL, as in the reference),
the GS strategies, dense RK, ``overlap``, ``compress`` and
``partition="balanced"`` (ROADMAP queue 1 item 8).

Pick streams: ``picks=`` overrides them; otherwise they are drawn with a
``torch.Generator`` from one ``seed`` (not the reference's threefry
stream).  ``banded_rk`` draws one global stream of block rows ∝ panel
norms, the same on every rank, from ``seed``; ``sparse_rk`` draws each
rank's rows ∝ its slab's row norms from ``seed * P + rank`` (the
counterpart of ``fold_in(key, rank)``).

The result holds the calling rank's replica.  Replicas agree to the last
bits only: each rank applied its own updates in its kernel and the
others' through the sum.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.engine import (ParallelSolveResult, sample_rows,
                                     scheduled_tau)
from repro_torch.core.operators import CsrOp, EllOp
from repro_torch.kernels import ops

#: action x format x sync -> strategy, the rows of the reference's table
#: (``repro/core/engine.py``) that the port has.
_DISTRIBUTED_STRATEGIES = {
    ("rk", "BlockBandedOp", "psum"): "banded_rk",
    ("rk", "CsrOp", "psum"): "sparse_rk",
    ("rk", "EllOp", "psum"): "sparse_rk",
}


def _sync_bytes_per_round(kind: str, *, n: int, k: int,
                          num_workers: int) -> float:
    """Analytic per-round sync payload: bytes ONE rank sends per round,
    the f32 delta of the whole iterate (the compressed wires come with
    ``compress``, not ported yet).  At P = 1 no collective runs: 0 bytes."""
    if num_workers <= 1:
        return 0.0
    if kind in ("banded_rk", "sparse_rk"):
        return 4.0 * n * k                         # full-delta all-reduce
    raise ValueError(kind)


def _all_reduce(t: torch.Tensor, group, num_workers: int) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor); ``t`` itself at
    P = 1, where no collective runs."""
    if num_workers == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


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


def solve_distributed(
    op,
    b: torch.Tensor,
    x0: torch.Tensor,
    x_star: torch.Tensor | None = None,
    *,
    action: str = "rk",
    group,
    rounds: int,
    local_steps: int,
    beta: float = 1.0,
    sync: str = "auto",
    seed: int | None = None,
    picks: torch.Tensor | None = None,
) -> ParallelSolveResult:
    """P-way solve under the periodic-synchronization schedule; call it on
    every rank of ``group`` with the same arguments.

    ``sync="auto"`` resolves as the reference's rule does for Kaczmarz:
    the a2a exchange on CSR/ELL, which is not ported yet and raises (pass
    ``sync="psum"``, whose iterates the reference pins bitwise to a2a's),
    else the psum.  The GS rules come with the GS strategies.  ``picks`` (else ``seed``) gives the streams:
    ``(rounds, P, local_steps)`` slab-local row ids for ``sparse_rk``,
    ``(rounds, local_steps)`` global block-row ids for ``banded_rk``.
    ``x0`` is not modified.
    """
    if rounds <= 0 or local_steps <= 0:
        raise ValueError(f"need rounds > 0 and local_steps > 0 (got "
                         f"{rounds}, {local_steps})")
    num_workers = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if sync == "auto" and action == "rk":
        sync = "a2a" if isinstance(op, (CsrOp, EllOp)) else "psum"
    kind = _DISTRIBUTED_STRATEGIES.get((action, type(op).__name__, sync))
    if kind is None:
        if action == "rk" and sync == "a2a" and isinstance(op, (CsrOp, EllOp)):
            raise NotImplementedError(
                f"the a2a delta exchange of Kaczmarz on {type(op).__name__} "
                "(the reference's sync='auto' choice there) is not ported "
                "yet (ROADMAP queue 1 item 8); pass sync='psum', whose "
                "iterates the reference pins bitwise to a2a's")
        supported = "\n  ".join(
            f"action={a!r} x format={f} x sync={s!r}"
            for (a, f, s) in sorted(_DISTRIBUTED_STRATEGIES))
        raise NotImplementedError(
            f"no distributed strategy for action={action!r}, "
            f"format={type(op).__name__}, sync={sync!r}; supported "
            f"combinations:\n  {supported}")
    if picks is None and seed is None:
        raise ValueError("solve_distributed needs a seed or picks")
    run = _sparse_rk if kind == "sparse_rk" else _banded_rk
    x, errs, resids = run(op, b, x0, x_star, group=group, rank=rank,
                          num_workers=num_workers, rounds=rounds,
                          local_steps=local_steps, beta=beta, seed=seed,
                          picks=picks)
    tau = scheduled_tau(num_workers, local_steps, shared_stream=True,
                        local_sampling=kind == "sparse_rk")
    return ParallelSolveResult(
        x=x, err_sq=torch.stack(errs), resid=torch.stack(resids), tau=tau,
        bytes_per_round=_sync_bytes_per_round(
            kind, n=x0.shape[0], k=b.shape[1], num_workers=num_workers))


def _nan_err(x: torch.Tensor) -> torch.Tensor:
    return torch.full((x.shape[1],), math.nan, dtype=torch.float32,
                      device=x.device)


def _sparse_rk(op, b, x0, xs, *, group, rank, num_workers, rounds,
               local_steps, beta, seed, picks):
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
        err, resid = metrics(x)
        errs.append(err)
        resids.append(resid)
    return x, errs, resids


def _banded_rk(op, b, x0, xs, *, group, rank, num_workers, rounds,
               local_steps, beta, seed, picks):
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
        res = b_sh - op.matvec(x)[row0:row0 + slab]
        resids.append(torch.sqrt(_all_reduce(ops.colsum(res * res), group,
                                             num_workers)))
        errs.append(_nan_err(x) if xs is None
                    else ops.colsum((x - xs) * (x - xs)))
    return x, errs, resids
