"""The sequential solver engine (port of the sequential part of
``repro/core/engine.py``).

Two actions over one pick stream:

* ``"gs"`` — randomized coordinate Gauss-Seidel (the paper's Alg. 1) on a
  unit-diagonal SPD system, coordinates drawn uniformly;
* ``"rk"`` — randomized Kaczmarz (Sec. 7), rows drawn with probability
  proportional to ``||A_i||^2``.

Each record chunk is one sweep call on the operator (``op.gs_sweep`` /
``op.rk_sweep``): on a CSR, ELL or block-banded operator on the card that
is one launch of its sweep kernel, on the CPU its plain version; a dense
operator has no kernel and steps through its picks in plain PyTorch.  On
the block-banded format a GS pick is a whole block row (``op.nb``
directions); it has no sequential Kaczmarz action (the reference's banded
Kaczmarz runs only in its distributed engine).

Picks are drawn with a ``torch.Generator``: a different stream from the
reference's ``jax.random`` threefry key.  ``picks=`` overrides the drawn
stream, which is how the tests feed both packages the same directions.

Not ported yet: the bounded-delay simulator (ROADMAP queue 1 item 6), the
distributed engine (item 8), the serving unit (item 4) and block GS with
``gs_block > 1`` on the dense and CSR formats.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.operators import BlockBandedOp, as_operator


class SolveResult(NamedTuple):
    x: torch.Tensor        # (n, k) final iterate
    err_sq: torch.Tensor   # (records, k) squared error at each record point
    resid: torch.Tensor    # (records, k) ||b - A x||_2 at each record point
    iters: torch.Tensor    # (records,) iteration index of each record


class Schedule(NamedTuple):
    """Execution plan for ``solve``: ``num_iters`` sequential steps,
    recorded every ``record_every`` steps (``0``: once, at the end).

    The reference's other modes (the bounded-delay simulator's ``tau``,
    the distributed ``rounds``/``local_steps`` and their options) are not
    ported yet (ROADMAP queue 1 items 6 and 8); their fields come with
    them.
    """
    num_iters: int = 0
    record_every: int = 0

    def validate(self) -> "Schedule":
        if self.num_iters <= 0:
            raise ValueError(
                f"a sequential Schedule needs num_iters > 0 (got {self})")
        return self


def _colsum(t: torch.Tensor) -> torch.Tensor:
    """Sum over rows per column, each column reduced on its own contiguous
    copy, so a column's result does not depend on how many columns ride
    along (zero-padded RHS columns leave the others bitwise unchanged)."""
    return t.T.contiguous().sum(1)


def record_metrics(op, b, x, x_star, *, norm: str):
    """(err_sq, resid) per RHS column.

    ``norm="A"``: ||x - x*||_A^2; ``norm="euclid"``: ||x - x*||_2^2.
    ``resid`` is always ||b - A x||_2.  ``x_star=None`` yields NaN
    ``err_sq`` and the finite residual.

    A·x goes through ``op.matvec``: the CSR matvec kernel on the card, its
    plain version on the CPU.  (The reference calls its jnp segment sum,
    ``matvec_ref``, here; the two compute the same function.)
    """
    if norm not in ("A", "euclid"):
        raise ValueError(norm)
    if x_star is None:
        err = torch.full((x.shape[1],), math.nan, dtype=torch.float32,
                         device=x.device)
    else:
        e = x - x_star
        err = _colsum(e * (op.matvec(e) if norm == "A" else e))
    r = b - op.matvec(x)
    return err, torch.sqrt(_colsum(r * r))


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

    All-zero ``rn`` samples uniformly instead (``multinomial`` raises on a
    zero distribution), as the reference defines it.
    """
    if not bool((rn > 0).any()):
        return torch.randint(0, rn.shape[0], (num,), generator=generator,
                             device=rn.device)
    return torch.multinomial(rn, num, replacement=True, generator=generator)


def num_directions(op, action: str) -> int:
    """How many directions a pick chooses from: block rows for GS on the
    block-banded format, rows otherwise."""
    if action == "gs" and isinstance(op, BlockBandedOp):
        return op.nb
    return op.shape[0]


def draw_picks(op, action: str, num_iters: int, *,
               generator: torch.Generator) -> torch.Tensor:
    """The sequential engine's direction stream: GS directions (coordinates,
    or block rows of a block-banded operator) uniform, RK rows ∝
    ||A_i||^2."""
    if action == "gs":
        return torch.randint(0, num_directions(op, action), (num_iters,),
                             generator=generator, device=op.device)
    if action == "rk":
        return sample_rows(op.row_norms_sq(), num_iters, generator=generator)
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
    record_every: int = 0,
) -> SolveResult:
    """Sequential randomized solve: one local-update step per iteration.

    The direction stream is ``picks`` when given (``num_iters`` row ids),
    else drawn from ``generator``.  Each record chunk is one
    ``op.gs_sweep`` / ``op.rk_sweep`` call.  ``x0`` is not modified.
    """
    if action not in ("gs", "rk"):
        raise ValueError(f"unknown action: {action!r}")
    if action == "rk" and isinstance(op, BlockBandedOp):
        raise NotImplementedError(
            "sequential RK needs per-row access (dense, ELL or CSR); the "
            "banded Kaczmarz action belongs to the distributed engine, not "
            "ported yet (ROADMAP queue 1 item 8)")
    rec = resolve_record_every(num_iters, record_every)
    if picks is None:
        if generator is None:
            raise ValueError("solve_sequential needs a generator or picks")
        picks = draw_picks(op, action, num_iters, generator=generator)
    else:
        picks = torch.as_tensor(picks, device=op.device)
        if picks.shape != (num_iters,):
            raise ValueError(f"picks has shape {tuple(picks.shape)}, "
                             f"expected ({num_iters},)")
        lo, hi = (int(v) for v in torch.aminmax(picks))
        top = num_directions(op, action)
        if lo < 0 or hi >= top:
            raise IndexError(f"pick ids span [{lo}, {hi}], allowed "
                             f"[0, {top})")
    rn = op.row_norms_sq() if action == "rk" else None
    norm = "A" if action == "gs" else "euclid"
    x = x0
    errs, resids = [], []
    for c in range(num_iters // rec):
        ps = picks[c * rec:(c + 1) * rec]
        if action == "gs":
            x = op.gs_sweep(b, x, ps, beta=beta)
        else:
            x = op.rk_sweep(b, rn, x, ps, beta=beta)
        err, resid = record_metrics(op, b, x, x_star, norm=norm)
        errs.append(err)
        resids.append(resid)
    iters = (1 + torch.arange(num_iters // rec, device=x.device)) * rec
    return SolveResult(x=x, err_sq=torch.stack(errs),
                       resid=torch.stack(resids), iters=iters)


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
    x0: torch.Tensor | None = None,
):
    """One front door for the solver family, on the device of the
    problem's tensors.

    ``problem`` is an ``SPDProblem`` (GS action by default) or an
    ``LSQProblem`` (Kaczmarz by default).  ``format`` picks the operator
    ("dense", "banded", "ell" or "csr"); ``block``/``bands`` shape the
    banded format, ``width`` the ELL format (``None``: every row's nonzeros
    fit; a smaller width keeps each row's largest), ``rows_per_panel``
    the CSR panel layout (``None``: 8), ``storage_dtype`` the coefficient
    precision (``None`` keeps the input dtype; the iterate, ``b`` and all
    accumulation stay f32).  The direction stream comes from ``generator``
    or, when given, ``picks``.
    """
    if action is None:
        action = "rk" if hasattr(problem, "sigma_min") else "gs"
    schedule.validate()
    op = as_operator(problem.A, format, block=block, bands=bands, width=width,
                     rows_per_panel=rows_per_panel or 8,
                     storage_dtype=storage_dtype)
    if x0 is None:
        # From b and the operator, not from x_star (which may be None): the
        # RK iterate lives in column space while b lives in row space.
        n_x = op.shape[0] if action == "gs" else op.shape[1]
        x0 = torch.zeros((n_x, problem.b.shape[1]), dtype=problem.b.dtype,
                         device=problem.b.device)
    return solve_sequential(
        op, problem.b, x0, problem.x_star, action=action,
        num_iters=schedule.num_iters, generator=generator, picks=picks,
        beta=beta, record_every=schedule.record_every)
