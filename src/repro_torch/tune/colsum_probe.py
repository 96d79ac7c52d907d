"""Time the records' column sums (``ops.colsum``) against ``torch.sum``.

    PYTHONPATH=src python -m repro_torch.tune.colsum_probe [--turns 2]

For each (n, k) of ``SHAPES`` (the main paths' record sums: CSR GS, ELL
GS and banded GS at n = 16384, CSR RK's residual at 32768 rows and its
error at 4096, and one column), a tensor of squares from seed 0 on the
card.  Each turn times ``ops.colsum`` and ``torch.sum(t, 0)``, the mean
ms a call of ``REPS`` calls between two CUDA events, launched from Python
(what a record pays) and replayed from one CUDA graph (the card's time
with the host's launch work taken out).  Then it checks ``ops.colsum``
against its plain version (``COLSUM_RTOL`` * sum |t| a column) and its
column 0 bitwise against the one-column sum.  Prints the card, then one
JSON line; exits 1 if a check fails.  Built for comparing versions of
``csrc/colsum.cu`` in one call: run this file with each copy's ``src`` on
PYTHONPATH, in turns.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from repro_torch.kernels import ops, ref
from repro_torch.tune.table import card_name

SHAPES = ((16384, 51), (32768, 51), (4096, 51), (16384, 1))
REPS = 50
COLSUM_RTOL = 2e-5


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _graph_ms(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    return _ms(graph.replay) / REPS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    gen = torch.Generator("cuda").manual_seed(0)
    tensors = {f"{n}x{k}": torch.randn((n, k), generator=gen,
                                       device="cuda") ** 2
               for n, k in SHAPES}
    turns = []
    for _ in range(args.turns):
        turn = {}
        for tag, t in tensors.items():
            for name, fn in (("colsum", functools.partial(ops.colsum, t)),
                             ("torch_sum",
                              functools.partial(torch.sum, t, 0))):
                turn[f"{name}_{tag}"] = _ms(fn)
                turn[f"{name}_{tag}_graph"] = _graph_ms(fn)
        turns.append(turn)
    checks = {}
    for tag, t in tensors.items():
        got = ops.colsum(t)
        err = (got - ref.colsum_ref(t)).abs()
        one = ops.colsum(t[:, :1].contiguous())
        checks[tag] = bool((err <= COLSUM_RTOL * t.sum(0)).all()
                           and torch.equal(one[0], got[0]))
    card = card_name()
    print(card)
    print(json.dumps({"reps": REPS, "turns": turns, "checks": checks}))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
