"""Time the two CUDA paths of the GS and Kaczmarz sweeps at main-path
shapes, in turns.

    PYTHONPATH=src python -m repro_torch.tune.sweep_probe [--turns 2]
        [--repeats 5]

Synthetic row windows, all from seed 0 on the card: for GS, ``GS_N`` rows
of width ``GS_WIDTH`` over an ``GS_N``-row iterate (the diagonal first with
value 1, then random columns with values 0.05 N(0, 1)); for the two RK
sweeps, ``RK_M`` rows of width ``RK_WIDTH`` over an ``RK_N``-row iterate
(distinct columns a row, values N(0, 1), divisor the squared row norm);
random b, x, and a chunk of picks (``GS_N`` and ``RK_M`` of them), k =
``K``.  Each turn times, for each kernel, the shared-memory path and then
the global path (``kernels/sweep_csr.py`` told which) on the whole chunk
and on its first 2048 picks: min of ``--repeats`` launches each, CUDA
events.  The delta sweep starts from d = 0, as a round does.  Then it
checks each kernel: its two paths bitwise equal on the chunk, and the
shared-memory path within ``SWEEP_RTOL`` (rel ||dx||) of the plain version
(``kernels/ref.py``) on the prefix.  Prints the card, then one JSON line:
the times of every turn (ms), the relative errors and whether the paths
agree bitwise, per kernel; exits 1 if a check fails.  Built for comparing
versions of ``csrc/sweep_csr.cu`` in one call: run it from each copy of
the tree in turns.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import json

import torch

from repro_torch.kernels import ref, sweep_csr
from repro_torch.tune.table import card_name

PREFIX = 2048
K = 51
GS_N, GS_WIDTH = 16384, 51                  # random_sparse_spd(16384)
RK_M, RK_N, RK_WIDTH = 32768, 4096, 16      # random_sparse_lsq(32768, 4096)
SWEEP_RTOL = 1e-5


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


def _sweeps(dev):
    """kernel name -> (fn(picks, shared) -> outputs, plain(picks) ->
    outputs, chunk picks)."""
    gen = torch.Generator(dev).manual_seed(0)
    cols = torch.randint(0, GS_N, (GS_N, GS_WIDTH), generator=gen, device=dev,
                         dtype=torch.int32)
    cols[:, 0] = torch.arange(GS_N, device=dev, dtype=torch.int32)
    vals = torch.randn((GS_N, GS_WIDTH), generator=gen, device=dev) * 0.05
    vals[:, 0] = 1.0
    b = torch.randn((GS_N, K), generator=gen, device=dev)
    x = torch.randn((GS_N, K), generator=gen, device=dev)
    gs_picks = torch.randint(0, GS_N, (GS_N,), generator=gen, device=dev,
                             dtype=torch.int32)

    offs = torch.randperm(RK_N - 1, generator=gen,
                          device=dev)[:RK_WIDTH - 1] + 1
    base = torch.randint(0, RK_N, (RK_M, 1), generator=gen, device=dev)
    rcols = torch.cat([base, (base + offs[None, :]) % RK_N], 1).to(torch.int32)
    rvals = torch.randn((RK_M, RK_WIDTH), generator=gen, device=dev)
    rn = (rvals * rvals).sum(1)
    rb = torch.randn((RK_M, K), generator=gen, device=dev)
    rx = torch.randn((RK_N, K), generator=gen, device=dev)
    rd = torch.zeros_like(rx)
    rk_picks = torch.randint(0, RK_M, (RK_M,), generator=gen, device=dev,
                             dtype=torch.int32)

    def gs(p, shared):
        return (sweep_csr.sweep_rows_gs(vals, cols, b, x, p, beta=1.0,
                                        write_base=0, limit=GS_N,
                                        _shared=shared),)

    def rk(p, shared):
        return (sweep_csr.sweep_rows_rk(rvals, rcols, rb, rn, rx, p, beta=1.0,
                                        limit=RK_M, _shared=shared),)

    def rk_delta(p, shared):
        return sweep_csr.sweep_rows_rk_delta(rvals, rcols, rb, rn, rx, rd, p,
                                             beta=1.0, limit=RK_M,
                                             _shared=shared)

    def gs_plain(p):
        return (ref.sweep_rows_gs_ref(vals, cols, b, x, p, beta=1.0),)

    def rk_plain(p):
        return (ref.sweep_rows_rk_ref(rvals, rcols, rb, rn, rx, p, beta=1.0),)

    def rk_delta_plain(p):
        return ref.sweep_rows_rk_delta_ref(rvals, rcols, rb, rn, rx, rd, p,
                                           beta=1.0)

    return {"gs": (gs, gs_plain, gs_picks), "rk": (rk, rk_plain, rk_picks),
            "rk_delta": (rk_delta, rk_delta_plain, rk_picks)}


def _rel(a, b) -> float:
    return float((a - b).double().norm() / (b.double().norm() + 1e-300))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    sweeps = _sweeps("cuda")
    turns = []
    for _ in range(args.turns):
        turns.append({f"{name}_{path}_{span}": _ms(
            functools.partial(fn, p, path == "shared"), args.repeats)
            for name, (fn, _, picks) in sweeps.items()
            for path in ("shared", "global")
            for span, p in (("chunk", picks), ("prefix", picks[:PREFIX]))})
    bitwise = {name: all(torch.equal(a, g) for a, g in zip(fn(picks, True),
                                                           fn(picks, False)))
               for name, (fn, _, picks) in sweeps.items()}
    rel_err = {name: max(_rel(a, w) for a, w in zip(
        fn(picks[:PREFIX], True), plain(picks[:PREFIX])))
        for name, (fn, plain, picks) in sweeps.items()}
    card = card_name()
    print(card)
    print(json.dumps({"k": K, "gs": [GS_N, GS_WIDTH],
                      "rk": [RK_M, RK_N, RK_WIDTH], "turns": turns,
                      "bitwise": bitwise, "rel_err_prefix": rel_err}))
    ok = all(bitwise.values()) and max(rel_err.values()) <= SWEEP_RTOL
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
