"""The paper's drivers in one run (the counterpart of the reference's
``benchmarks/run.py``, without its ``bench_kernels`` job):

    python -m repro_torch.paper.run [--only NAME] [--fast] [--device cpu]

One module per paper figure and the theorem validation; output is CSV-ish
lines ``name,key=value,...``.  ``--fast`` takes smaller problem sizes,
``--only`` keeps the jobs whose name contains it.  A job that raises is
reported and the next one runs.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

import torch

from repro_torch.paper import (fig1_residual, fig2_scaling,
                               fig3_async_penalty, theory_validation)


def jobs(fast: bool, device: torch.device):
    """(name, thunk) of the four drivers at the reference's sizes."""
    return [
        ("fig1_residual", lambda: fig1_residual.run(
            n=1024 if fast else 2048, device=device)),
        ("fig2_scaling", lambda: fig2_scaling.run(
            n=512 if fast else 1024,
            workers=(1, 2, 4) if fast else (1, 2, 4, 8), device=device)),
        ("fig3_async_penalty", lambda: fig3_async_penalty.run(
            n=512 if fast else 1024,
            taus=(4, 16) if fast else (4, 16, 64),
            trials=3 if fast else 5, device=device)),
        ("theory_validation", lambda: theory_validation.run(
            n=256 if fast else 512, seeds=4 if fast else 8, device=device)),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="substring filter")
    ap.add_argument("--fast", action="store_true",
                    help="smaller problem sizes")
    ap.add_argument("--device", default="cuda",
                    help="where the problems and the solves live (cuda "
                         "raises without a card; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    for name, fn in jobs(args.fast, torch.device(args.device)):
        if args.only and args.only not in name:
            continue
        t0 = time.time()
        print(f"# === {name} ===", flush=True)
        try:
            fn()
        except Exception as e:  # keep the runner going; the trace to stderr
            traceback.print_exc(file=sys.stderr)
            print(f"{name},error={type(e).__name__}:{e}", flush=True)
        print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
