"""The comparison that decides ``correct``: a program's solves or sweeps held
against the reference's replay of the same picks from the same start.

Three numbers, each with its limit from the cell's file:

* ``x_err`` — the largest ``||x_prog - x_ref||_2 / ||x_ref||_2`` over the
  checked units and columns: the sweep kernel's chain;
* ``record_err`` — the largest gap between the residual norm the
  program's last record reports and the reference's residual norm of the
  program's own x, over the larger of the column's tolerance and that
  norm: the records' matvec, ``colsum`` and square root;
* ``exit_mismatch`` — how many columns the program stopped or flagged
  otherwise than the reference's residuals along its own replay say, and
  whether the solve stopped at the record it should have; limit 0.  A
  column's decision counts as right wherever the reference's residual
  lies within ``EXIT_BAND`` of the tolerance (relative), since rounding
  may tip it either way there.

``traj_err`` (the gap between the program's last residuals and the
reference's along its own replay, over the same scale) is read, not
compared: it shows how wide the band has to be.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from bench.reference import gs

#: The relative band about a tolerance inside which either exit decision
#: counts as right.
EXIT_BAND = 1e-3


@dataclass
class Unit:
    """What the program returned for one solve or sweep, and its inputs."""

    b: torch.Tensor            # (n, k) float32
    tol: torch.Tensor          # (k,) the absolute tolerances handed over
    picks: torch.Tensor        # the picks of the records it ran, in order
    x_in: torch.Tensor         # the iterate it started from
    x: torch.Tensor            # the iterate it returned
    resid: torch.Tensor        # (k,) its last record's residuals
    rounds: torch.Tensor       # (k,) records each column needed (host)
    converged: torch.Tensor    # (k,) bool (host)
    iters_run: int
    per_record: int            # picks a record
    cap_records: int           # records the solve may run at most
    block: int = 1


@dataclass
class Readings:
    x_err: float = 0.0
    record_err: float = 0.0
    exit_mismatch: int = 0
    traj_err: float = 0.0
    units: int = 0
    detail: list = field(default_factory=list)

    def worst(self, other: "Readings") -> "Readings":
        return Readings(max(self.x_err, other.x_err, key=_order),
                        max(self.record_err, other.record_err, key=_order),
                        self.exit_mismatch + other.exit_mismatch,
                        max(self.traj_err, other.traj_err, key=_order),
                        self.units + other.units, self.detail + other.detail)


def _order(v: float) -> float:
    """NaN sorts above everything, so a NaN reading is the worst."""
    return float("inf") if v != v else v


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(gs.F64) - b).norm(dim=0) / b.norm(dim=0)


def _gap(resid: torch.Tensor, ref: torch.Tensor, tol: torch.Tensor) -> float:
    return float(((resid.cpu().to(gs.F64) - ref).abs()
                  / torch.maximum(tol, ref)).max())


def check_unit(A: gs.Matrix, u: Unit, band: float = EXIT_BAND) -> Readings:
    """Replay ``u``'s records on the reference and read the numbers."""
    x = u.x_in.to(gs.F64)
    records = u.iters_run // u.per_record
    history = []
    for r in range(records):
        x = gs.sweep(A, u.b, x, u.picks[r * u.per_record:(r + 1) * u.per_record],
                     block=u.block)
        history.append(A.residual(u.b, x))
    history = torch.stack(history).cpu()            # (records, k)
    x_err = float(_rel(u.x, x).max())
    tol = u.tol.cpu().to(gs.F64)
    record_err = _gap(u.resid, A.residual(u.b, u.x).cpu(), tol)
    traj_err = _gap(u.resid, history[-1], tol)
    hi, lo = tol * (1 + band), tol * (1 - band)
    bad = 0
    for c in range(tol.numel()):
        h = history[:, c]
        if bool(u.converged[c]):
            r = int(u.rounds[c])
            ok = (1 <= r <= records and bool(h[r - 1] <= hi[c])
                  and bool((h[:r - 1] > lo[c]).all()))
        else:
            ok = bool((h > lo[c]).all())
        bad += not ok
    # The solve stops at the first record where every column has met its
    # tolerance, and otherwise runs to its cap.
    done = bool(u.converged.all())
    want = int(u.rounds.max()) if done else u.cap_records
    bad += records != want
    return Readings(x_err, record_err, bad, traj_err, 1,
                    [dict(records=records, x_err=x_err, record_err=record_err,
                          traj_err=traj_err, mismatch=bad)])


def check(A: gs.Matrix, units: list[Unit],
          band: float = EXIT_BAND) -> Readings:
    out = Readings()
    for u in units:
        out = out.worst(check_unit(A, u, band))
    return out


def verdict(readings: Readings, limits: dict) -> tuple[bool, dict]:
    """(correct, each number beside its limit)."""
    numbers = {"x_err": readings.x_err, "record_err": readings.record_err,
               "exit_mismatch": readings.exit_mismatch}
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = readings.units > 0 and all(v <= limits[k] for k, v in numbers.items())
    return ok, table
