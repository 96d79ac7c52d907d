"""Time the banded sweeps at the main path's shapes and print digests of
their outputs, so that two versions of ``csrc/banded_gs.cu`` can be
compared for speed and bitwise in one call.

    PYTHONPATH=src python -m repro_torch.tune.banded_probe [--label C1]
        [--repeats 5]

The problem is ``block_banded_spd(16384, block=128, bands=2)`` (seed 0)
with its tiles stored in f32 and in bf16, k = 51: b from the problem, a
window of random x (seed 0 on the card), and from the same generator:

- ``gs``: a GS chunk of 128 picks (one sweep of nb block rows);
- ``rk1``: an RK round at P = 1, 128 picks, every gate 1, from dw = 0;
- ``rk4``: an RK round at P = 4, 32 picks of the global panel stream on
  rank 1's window (nb / 4 block rows with their halos), gates 1 only for
  the picks that rank owns, on a random dw.

Each runs through the bare launcher (``kernels/banded_gs.py``) on every
path the tree offers: the shared-memory and the global path where the
launcher takes ``_shared``, else its one path.  Per case and path: the
min of ``--repeats`` launches (CUDA events) and the SHA-256 of the
output's bytes (xw, then dw).  Prints the card (``nvidia-smi``), then
one JSON line.  Exits 1 if the paths of a case disagree.  To compare
trees, run this file with ``PYTHONPATH`` at each tree's ``src`` in turns
(parent, change, change, parent) and compare the digests.  Needs a card.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import inspect
import json

import torch

from repro_torch.core.operators import as_operator
from repro_torch.core.spd import block_banded_spd
from repro_torch.kernels import banded_gs
from repro_torch.tune.table import card_name

N, BLOCK, BANDS, K = 16384, 128, 2, 51
P4, P4_STEPS = 4, 32
BETA = 0.9


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


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _variants() -> dict[str, dict]:
    """variant name -> keyword arguments of the launchers."""
    params = inspect.signature(banded_gs.banded_gs_sweep).parameters
    if "_shared" not in params:
        return {"only": {}}
    return {path: {"_shared": path == "shared"}
            for path in ("shared", "global")}


def _cases(dev) -> dict:
    """case name -> fn(**variant) -> output, for f32 and bf16 tiles."""
    prob = block_banded_spd(N, block=BLOCK, bands=BANDS, n_rhs=K, seed=0,
                            device=dev)
    nb, halo = N // BLOCK, BANDS * BLOCK
    gen = torch.Generator(dev).manual_seed(0)
    xw = torch.nn.functional.pad(
        torch.randn((N, K), generator=gen, device=dev), (0, 0, halo, halo))
    picks = torch.randint(0, nb, (nb,), generator=gen, device=dev,
                          dtype=torch.int32)
    nb_local = nb // P4
    row0 = nb_local * BLOCK
    li = torch.randint(0, nb, (P4_STEPS,), generator=gen,
                       device=dev) - nb_local
    gates4 = ((li >= 0) & (li < nb_local)).to(torch.int32)
    picks4 = li.clamp(0, nb_local - 1).to(torch.int32)
    xw4 = xw[row0:2 * row0 + 2 * halo].contiguous()
    dw4 = torch.randn(xw4.shape, generator=gen, device=dev)
    ones = torch.ones_like(picks)
    zero = torch.zeros_like(xw)
    kw = dict(block=BLOCK, bands=BANDS, beta=BETA)
    cases = {}
    for sd in (None, "bfloat16"):
        op = as_operator(prob.A, "banded", block=BLOCK, bands=BANDS,
                         storage_dtype=sd)
        tiles = op.packed_band_tiles()
        rn = op.row_norms_sq()
        rn = torch.where(rn > 0, rn, 1.0)
        tiles4 = tiles[nb_local:2 * nb_local]
        tag = "f32" if sd is None else "bf16"
        cases[f"gs_{tag}"] = functools.partial(
            banded_gs.banded_gs_sweep, tiles, prob.b, xw, picks, limit=nb,
            **kw)
        cases[f"rk1_{tag}"] = functools.partial(
            banded_gs.banded_rk_sweep, tiles, prob.b, rn, xw, zero, picks,
            ones, limit=nb, **kw)
        cases[f"rk4_{tag}"] = functools.partial(
            banded_gs.banded_rk_sweep, tiles4, prob.b[row0:2 * row0],
            rn[nb_local:2 * nb_local], xw4, dw4, picks4, gates4,
            limit=nb_local, **kw)
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    cases = _cases("cuda")
    variants = _variants()
    result, agree = {}, True
    for name, fn in cases.items():
        ms, sha = {}, {}
        for var, kw in variants.items():
            sha[var] = _digest(fn(**kw))
            ms[var] = _ms(functools.partial(fn, **kw), args.repeats)
        agree &= len(set(sha.values())) == 1
        result[name] = {"ms": ms, "sha256": sha}
    card = card_name()
    print(card)
    print(json.dumps({"label": args.label, "k": K, "cases": result,
                      "variants_agree": agree}))
    return 0 if agree else 1


if __name__ == "__main__":
    raise SystemExit(main())
