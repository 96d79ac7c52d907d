"""The autotuner CLI: measure the tunable axes, persist the winners (port of
``repro/tune/autotune.py``).

    PYTHONPATH=src python -m repro_torch.tune.autotune sweep --n 16384 --out T.json
    PYTHONPATH=src python -m repro_torch.tune.autotune show  [T.json]
    PYTHONPATH=src python -m repro_torch.tune.autotune diff  A.json [B.json]

``sweep`` times every candidate of each tunable axis on reference problems
at the requested shape, on the card (``--device cpu`` times the plain
versions on the CPU instead), min of ``--repeats`` runs each (CUDA events
on the card, the host clock on the CPU), and writes the winners to a new
table at ``--out``, and nowhere else.  To install a table as the default,
write it to ``TUNE_torch_<backend>.json`` at the root of the checkout.
Axes:

* ``matvec`` — the CSR variant family (``sliced`` / ``sliced_prefetch`` /
  ``segsum`` / ``segsum_prefetch``), each timed on a dense-panel pattern
  and a half-empty ("patchy") one; the winner is the least total time
  over the two (one entry per bucket must serve both);
* ``panel`` — CSR ``rows_per_panel`` candidates under the default matvec.

The reference's ``sweep`` axis (fused sweep vs per-step scan) has no
counterpart: the port has one engine.  ``show`` prints a table's identity
and choices; ``diff`` exits non-zero iff two tables disagree on a key or
cover different keys.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.tune.table import (MATVEC_VARIANTS, TuningTable,
                                    default_path, shape_bucket)

#: CSR rows_per_panel candidates ("panel" axis)
PANEL_CANDIDATES = (4, 8, 16)


def timed_us(fn, *, repeats: int, device) -> float:
    """Least time of one ``fn()`` call over ``repeats`` calls, in
    microseconds, after one warm-up call: CUDA events on the card, the
    host clock on the CPU."""
    import torch
    fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def patchy(A, rows_per_panel: int):
    """A copy of ``A`` with every other row panel zeroed — the half-empty
    pattern a norm-balanced partition of banded structure produces (the
    case the predicated variants are for)."""
    Ap = A.clone()
    R = rows_per_panel
    for p in range(0, Ap.shape[0] // R, 2):
        Ap[p * R:(p + 1) * R] = 0.0
    return Ap


def sweep_matvec(table: TuningTable, prob, *, repeats: int, device,
                 storage_dtype=None) -> None:
    from repro_torch.core.operators import CsrOp
    from repro_torch.tune import runtime
    cop = CsrOp.from_dense(prob.A, storage_dtype=storage_dtype)
    pop = CsrOp.from_dense(patchy(prob.A, cop.rows_per_panel),
                           storage_dtype=storage_dtype)
    x = prob.x_star
    wall: dict[str, float] = {}
    with runtime.use_table(None):
        for v in MATVEC_VARIANTS:
            wall[v] = sum(timed_us(lambda op=op, v=v: op.matvec(x, variant=v),
                                   repeats=repeats, device=device)
                          for op in (cop, pop))
            print(f"[tune] matvec/{v:<16s} {wall[v]:10.1f} us "
                  f"(dense+patchy, n={cop.shape[0]})", flush=True)
    choice = min(wall, key=wall.get)
    table.record(runtime.matvec_key(cop), choice, wall)
    print(f"[tune] matvec winner @ {shape_bucket(cop.shape[0])}: {choice}",
          flush=True)


def sweep_panels(table: TuningTable, prob, *, repeats: int, device,
                 storage_dtype=None) -> None:
    from repro_torch.core.operators import CsrOp
    from repro_torch.tune import runtime
    x = prob.x_star
    wall: dict[str, float] = {}
    with runtime.use_table(None):
        for R in PANEL_CANDIDATES:
            op = CsrOp.from_dense(prob.A, rows_per_panel=R,
                                  storage_dtype=storage_dtype)
            wall[str(R)] = timed_us(lambda op=op: op.matvec(x),
                                    repeats=repeats, device=device)
            print(f"[tune] panel/rows_per_panel={R:<3d} {wall[str(R)]:10.1f} "
                  "us", flush=True)
    choice = min(wall, key=wall.get)
    m = prob.A.shape[0]
    table.record(runtime.panel_key(m, storage_dtype), choice, wall)
    print(f"[tune] panel winner @ {shape_bucket(m)}: rows_per_panel={choice}",
          flush=True)


def run_sweep(args) -> TuningTable:
    from repro_torch.core.spd import random_sparse_spd, resolve_device
    device = resolve_device(args.device)
    table = TuningTable.fresh(device)
    prob = random_sparse_spd(args.n, row_nnz=args.row_nnz, n_rhs=args.k,
                             seed=args.seed, device=device)
    kw = dict(repeats=args.repeats, device=device,
              storage_dtype=args.storage_dtype)
    sweep_matvec(table, prob, **kw)
    sweep_panels(table, prob, **kw)
    path = table.save(args.out)
    print(f"[tune] wrote {path} ({len(table.entries)} entries, "
          f"backend={table.backend}, device={table.device_kind})", flush=True)
    return table


def run_show(args) -> int:
    table = TuningTable.load(args.path or default_path())
    print(f"backend={table.backend} device_kind={table.device_kind} "
          f"torch={table.torch_version} version={table.version}")
    for key, choice in table.choices().items():
        walls = table.entries[key]["wall_us"]
        detail = " ".join(f"{c}={us:.1f}us" for c, us in walls.items())
        print(f"  {key:<42s} -> {choice:<16s} ({detail})")
    return 0


def run_diff(args) -> int:
    a = TuningTable.load(args.a)
    b = TuningTable.load(args.b or default_path())
    ca, cb = a.choices(), b.choices()
    drift = 0
    for key in sorted(set(ca) | set(cb)):
        va, vb = ca.get(key), cb.get(key)
        if va != vb:
            drift += 1
            print(f"  {key}: {va or '<missing>'} != {vb or '<missing>'}")
    if drift:
        print(f"[tune] {drift} key(s) differ")
        return 1
    print(f"[tune] identical choices ({len(ca)} keys)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.tune.autotune",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sw = sub.add_parser("sweep", help="measure candidates, persist winners")
    sw.add_argument("--n", type=int, default=1024)
    sw.add_argument("--k", type=int, default=8)
    sw.add_argument("--row-nnz", type=int, default=16)
    sw.add_argument("--repeats", type=int, default=3,
                    help="timing repetitions; winners are min-of-N")
    sw.add_argument("--storage-dtype", choices=("float32", "bfloat16"),
                    default=None)
    sw.add_argument("--seed", type=int, default=0)
    sw.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    sw.add_argument("--out", required=True,
                    help="output path (TUNE_torch_<backend>.json at the root "
                         "of the checkout makes it the default table)")
    sh = sub.add_parser("show", help="print a table's entries")
    sh.add_argument("path", nargs="?", default=None)
    df = sub.add_parser("diff", help="compare two tables' choices "
                                     "(exit 1 on drift)")
    df.add_argument("a")
    df.add_argument("b", nargs="?", default=None,
                    help="default: TUNE_torch_<backend>.json at the root")
    args = ap.parse_args(argv)
    if args.cmd == "sweep":
        run_sweep(args)
        return 0
    if args.cmd == "show":
        return run_show(args)
    return run_diff(args)


if __name__ == "__main__":
    sys.exit(main())
