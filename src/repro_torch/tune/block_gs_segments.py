"""Where a step of the dense block-GS sweep spends its cycles: clock64
segments of a unit's work on the main chunk, the products timed without
their shared-memory loads, and the design without its lookahead or with
larger units.

    PYTHONPATH=src python -m repro_torch.tune.block_gs_segments
        [--variants stamps,x_once,a_once,no_loads,no_lookahead,rows64]

For each variant it copies this tree's ``src`` to
``build/block_gs_segments/<variant>/src`` and patches
``csrc/block_gs.cu`` there (never the tree's own source).  Every variant
stamps ``clock64()`` around four segments of a unit's work: the sync and
x reload after its wait for the previous step, the wait for its panel
stage, the products, and the hand-off of its parts; per step it keeps
the largest of each over the CTAs' thread 0, for untouched and for
touched units apart.  ``x_once``, ``a_once`` and ``no_loads`` also load
x, the panel or both once before the products' loop and reuse those
values (wrong results: they time the loop without those loads).
``no_lookahead`` makes every unit wait for step s - 1 to be done, and
``rows64`` gives units 64 rows of the block (one a CTA at the main size);
neither moves the results' bits.  A child process on the copy runs the
f32 cases of ``tune/block_gs_probe.py`` (k = 51 and 1) and reports the
median over steps 1 ... 127 of each segment, in cycles, and the min of 5
launches of the stamped copy, in ms (CUDA events).  Prints the card
(``nvidia-smi``), one line a case, then one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
SEGMENTS = ("sync_reload", "panel_wait", "products", "hand_off")

_KERNEL = "template <typename V>\n__global__"
_STAMPS = [
    (_KERNEL, "__device__ unsigned long long g_seg[2][4][128];\n" + _KERNEL),
    ("        if (tid == 0 && need > 0) wait_geq(done, reducers * (unsigned)need);\n",
     "        if (tid == 0 && need > 0) wait_geq(done, reducers * (unsigned)need);\n"
     "        long long cc[5];\n        cc[0] = clock64();\n"),
    ("        const int stage = it % P.stages;\n        mbar_wait(",
     "        cc[1] = clock64();\n        const int stage = it % P.stages;\n"
     "        mbar_wait("),
    ("        const V* st = reinterpret_cast<const V*>(ring + stage * stage_bytes);\n",
     "        cc[2] = clock64();\n"
     "        const V* st = reinterpret_cast<const V*>(ring + stage * stage_bytes);\n"),
    ("        unit_parts(st, pe, X, KTP, RQ, CQ, w4, rv, kt, out, k, tid);\n",
     "        unit_parts(st, pe, X, KTP, RQ, CQ, w4, rv, kt, out, k, tid);\n"
     "        cc[3] = clock64();\n"),
    ("        ++it;\n      });\n      prev = a.blocks[s];\n    }\n"
     "  } else if (warp == kPublisher) {",
     "        cc[4] = clock64();\n"
     "        if (tid == 0 && s < 128)\n"
     "          for (int f = 0; f < 4; ++f)\n"
     "            atomicMax(&g_seg[t][f][s], (unsigned long long)(cc[f + 1] - cc[f]));\n"
     "        ++it;\n      });\n      prev = a.blocks[s];\n    }\n"
     "  } else if (warp == kPublisher) {"),
]
_STAMP_ENTRIES = """
extern "C" int block_gs_seg_reset() {
  static unsigned long long z[2 * 4 * 128];
  return (int)cudaMemcpyToSymbol(g_seg, z, sizeof z);
}
extern "C" int block_gs_seg_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_seg, sizeof(unsigned long long) * 2 * 4 * 128);
}
"""
_LOOP = "#pragma unroll 2\n    for (int j = 0; j < w4; j += 4) {\n"
_XLOAD = """      float xv[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 v = *reinterpret_cast<const float4*>(xc + (j + jj) * KTP);
        xv[jj][0] = v.x, xv[jj][1] = v.y, xv[jj][2] = v.z, xv[jj][3] = v.w;
      }
"""
_ALOAD = """        float av[4];
        load4(ar + (size_t)i * RQ * pe + j, av);
"""
_X_ONCE = [(_LOOP + _XLOAD, _XLOAD.replace("(j + jj)", "jj") + _LOOP)]
_A_ONCE = [
    (_ALOAD, ""),
    (_LOOP, "    float avs[kTile][4];\n#pragma unroll\n"
            "    for (int i = 0; i < kTile; ++i) load4(ar + (size_t)i * RQ * pe, avs[i]);\n"
     + _LOOP),
    ("acc[i][q] = fmaf(av[jj], xv[jj][q], acc[i][q]);",
     "acc[i][q] = fmaf(avs[i][jj], xv[jj][q], acc[i][q]);"),
]
VARIANTS = {"stamps": [], "x_once": _X_ONCE, "a_once": _A_ONCE,
            "no_loads": _X_ONCE + _A_ONCE,
            "no_lookahead": [("const int need = t ? s : s - kDepth + 1;",
                              "const int need = s;")],
            "rows64": [("constexpr int kRows = 32;",
                        "constexpr int kRows = 64;")]}


def patched(source: str, variant: str) -> str:
    """``csrc/block_gs.cu`` with the stamps and the variant's changes;
    raises if the source no longer has a line a patch expects."""
    for old, new in _STAMPS + VARIANTS[variant]:
        if source.count(old) != 1:
            raise ValueError(f"{variant}: csrc/block_gs.cu does not hold "
                             f"exactly one {old[:50]!r}")
        source = source.replace(old, new)
    return source + _STAMP_ENTRIES


def _child() -> dict:
    """Runs on the patched copy: median segment cycles and ms of each
    case."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.tune import block_gs_probe as probe

    lib = _build.library("block_gs")
    cases = probe._cases("cuda")
    out = {}
    for case in ("f32_k51", "f32_k1"):
        fn = cases[case]
        fn()
        torch.cuda.synchronize()
        lib.block_gs_seg_reset()
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * 4 * 128))()
        lib.block_gs_seg_get(buf)
        t = np.array(buf[:], dtype=np.float64).reshape(2, 4, 128)[:, :, 1:]
        out[case] = {
            kind: {seg: float(np.median(t[ti, f]))
                   for f, seg in enumerate(SEGMENTS)}
            for ti, kind in enumerate(("untouched", "touched"))}
        out[case]["ms"] = probe._ms(fn, 5)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child()))
        return 0
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    src = (ROOT / "src/repro_torch/csrc/block_gs.cu").read_text()
    result = {}
    for name in names:
        dst = ROOT / "build" / "block_gs_segments" / name
        shutil.rmtree(dst / "src", ignore_errors=True)
        shutil.copytree(ROOT / "src", dst / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "src/repro_torch/csrc/block_gs.cu").write_text(
            patched(src, name))
        env = dict(os.environ, PYTHONPATH=str(dst / "src"))
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune.block_gs_segments",
             "--child"], env=env, cwd=ROOT, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        result[name] = json.loads(run.stdout.strip().splitlines()[-1])
        for case, kinds in result[name].items():
            print(f"{name:12s} {case:8s} {kinds['ms']:.4f} ms | " + " | ".join(
                f"{seg} {kinds['untouched'][seg]:.0f}/"
                f"{kinds['touched'][seg]:.0f}" for seg in SEGMENTS),
                flush=True)
    from repro_torch.tune.table import card_name
    card = card_name()
    print(card)
    print(json.dumps({"segments": SEGMENTS, "variants": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
