"""Time the dense block-GS sweep on the main path's chunk and print digests
of its outputs, so that two versions of ``csrc/block_gs.cu`` can be
compared for speed and bitwise in one call.

    PYTHONPATH=src python -m repro_torch.tune.block_gs_probe [--label C1]
        [--repeats 5]

The problem is the dense matrix of ``block_banded_spd(16384, block=128,
bands=2)`` (seed 0), stored in f32 and in bf16; b from the problem, x
random (seed 0 on the card), and from the same generator one chunk of
128 block ids (one sweep of the 128 block rows).  Cases ``f32_k51``,
``bf16_k51``, ``f32_k1`` and ``bf16_k1``: the chunk at k = 51 and on
column 0 alone.

Each case runs through the bare launcher (``kernels/block_gs.py``).  Per
case: the min of ``--repeats`` launches (CUDA events) and the SHA-256 of
the output's bytes.  Prints the card (``nvidia-smi``), then one JSON
line.  Exits 1 if column 0 at k = 51 is not column 0 at k = 1.  To
compare trees, run this file with ``PYTHONPATH`` at each tree's ``src``
in turns (parent, change, change, parent) and compare the digests.
Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json

import torch

from repro_torch.core.spd import block_banded_spd
from repro_torch.kernels import block_gs
from repro_torch.tune.table import card_name

N, BLOCK, K = 16384, 128, 51
BETA = 0.9


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    return args


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


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _cases(dev) -> dict:
    """case name -> fn() -> output."""
    prob = block_banded_spd(N, block=BLOCK, bands=2, n_rhs=K, seed=0,
                            device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((N, K), generator=gen, device=dev)
    blocks = torch.randint(0, N // BLOCK, (N // BLOCK,), generator=gen,
                           device=dev, dtype=torch.int32)
    cases = {}
    for tag, A in (("f32", prob.A), ("bf16", prob.A.to(torch.bfloat16))):
        for k in (K, 1):
            cases[f"{tag}_k{k}"] = functools.partial(
                block_gs.block_gs_sweep, A, prob.b[:, :k].contiguous(),
                x[:, :k].contiguous(), blocks, block=BLOCK, beta=BETA,
                limit=N // BLOCK)
    return cases


def main(argv=None) -> int:
    args = parse_args(argv)
    cases = _cases("cuda")
    result, col0 = {}, {}
    for name, fn in cases.items():
        out = fn()
        col0.setdefault(name.split("_")[0], set()).add(_digest(out[:, 0]))
        result[name] = {"ms": _ms(fn, args.repeats), "sha256": _digest(out)}
    agree = all(len(d) == 1 for d in col0.values())
    card = card_name()
    print(card)
    print(json.dumps({"label": args.label, "n": N, "block": BLOCK,
                      "picks": N // BLOCK, "cases": result,
                      "column0_agrees": agree}))
    return 0 if agree else 1


if __name__ == "__main__":
    raise SystemExit(main())
