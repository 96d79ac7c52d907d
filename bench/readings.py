"""The readings a cell's correctness limits are set from (not run by the
benchmark's own runs).

    python3 bench/readings.py --workload <cell> --seeds 11 12 ...
        [--seconds 10] [--control] [--out FILE]

Builds the cell's operator once, then for each seed runs a window of the
cell's traffic as a run does (``harness.run_window``) and holds the units
a run would check against the reference, printing one JSON line a seed:
the largest ``x_err``, ``record_err`` and ``traj_err`` and the
``exit_mismatch`` count.  ``--control`` runs
the program's bfloat16 storage path in its place (``controls.py``).
The lower reading of a number is the largest over a dozen seeds of the
program; its upper reading the smallest over the control's seeds.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
    import torch

    from bench import controls, harness, registry

    torch.set_num_threads(1)            # as bench/run.py
    device = torch.device(args.device)
    cell = registry.cell(args.workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    op, driver, _, _, _ = harness.setup(config, traffic, args.seeds[0],
                                              device)
    if args.control:
        op = controls.bf16(op)
    harness.solve_unit(op, driver, -1, driver.start())       # warm-up
    lines = []
    for seed in args.seeds:
        driver.seed = seed
        keep = harness.Keep(driver.kind, harness.CHECK_UNITS, seed)
        units, _, window_s, _ = harness.run_window(op, driver, args.seconds,
                                                   keep)
        t1 = time.perf_counter()
        r = harness.reference_check(config, registry.ROOT, device, driver,
                                    keep.items())
        line = dict(workload=args.workload, seed=seed, control=args.control,
                    x_err=r.x_err, record_err=r.record_err,
                    traj_err=r.traj_err,
                    exit_mismatch=r.exit_mismatch,
                    records=[d["records"] for d in r.detail],
                    units=len(units), window_s=window_s,
                    reference_s=time.perf_counter() - t1)
        print(json.dumps(line), flush=True)
        lines.append(json.dumps(line))
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
