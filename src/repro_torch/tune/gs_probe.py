"""Time the GS sweep's two CUDA paths at a main-path shape, in turns.

    PYTHONPATH=src python -m repro_torch.tune.gs_probe [--n 16384] [--width 51]
        [--k 51] [--turns 2] [--repeats 5]

Synthetic row windows (the diagonal first with value 1, then random
columns with values 0.05 N(0, 1)), a random b and x and ``n`` random picks,
all from seed 0 on the card.  Each turn times the shared-memory path, then
the global path (``kernels/sweep_csr.py::sweep_rows_gs`` told which), on
the whole ``n``-pick chunk and on its first 2048 picks: min of
``--repeats`` launches each, CUDA events.  Prints the card, then one JSON
line: the times of every turn (ms) and whether the two paths agree
bitwise.  Built for comparing versions of ``csrc/sweep_csr.cu`` in one
call: run it from each copy of the tree in turns.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess

import torch

from repro_torch.kernels import sweep_csr

PREFIX = 2048


def _ms(fn, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--width", type=int, default=51)
    ap.add_argument("--k", type=int, default=51)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    n, width, k, dev = args.n, args.width, args.k, "cuda"
    gen = torch.Generator(dev).manual_seed(0)
    cols = torch.randint(0, n, (n, width), generator=gen, device=dev,
                         dtype=torch.int32)
    cols[:, 0] = torch.arange(n, device=dev, dtype=torch.int32)
    vals = torch.randn((n, width), generator=gen, device=dev) * 0.05
    vals[:, 0] = 1.0
    b = torch.randn((n, k), generator=gen, device=dev)
    x = torch.randn((n, k), generator=gen, device=dev)
    picks = torch.randint(0, n, (n,), generator=gen, device=dev,
                          dtype=torch.int32)

    def sweep(shared, p):
        return sweep_csr.sweep_rows_gs(vals, cols, b, x, p, beta=1.0,
                                       write_base=0, limit=n, _shared=shared)

    turns = []
    for _ in range(args.turns):
        turns.append({f"{path}_{span}": _ms(
            functools.partial(sweep, path == "shared", p), args.repeats)
            for path in ("shared", "global")
            for span, p in (("chunk", picks), ("prefix", picks[:PREFIX]))})
    bitwise = torch.equal(sweep(True, picks), sweep(False, picks))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"n": n, "width": width, "k": k, "turns": turns,
                      "bitwise": bitwise}))
    return 0 if bitwise else 1


if __name__ == "__main__":
    raise SystemExit(main())
