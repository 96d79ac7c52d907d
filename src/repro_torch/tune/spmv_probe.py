"""Time the CSR and ELL matvecs at the main path's shapes, from Python and
from a CUDA graph, and print digests of their outputs, so that two
versions of ``csrc/spmv_csr.cu`` / ``csrc/spmv_ell.cu`` can be compared
for speed and bitwise in one call; and time patched copies of the
row-window kernel.

    PYTHONPATH=src python -m repro_torch.tune.spmv_probe [--label C]
        [--turns 2] [--variants gather_only,all_slots,...]
        [--gather-floor] [--padding-sweep]

Timed cases (seed 0, k = 51, f32 values and int32 indices), each through
``kernels/ops.py``: ``spmv_csr_sliced`` on ``random_sparse_spd(16384,
row_nnz=16)`` (``sliced_spd``) and on ``random_sparse_lsq(32768, 4096,
row_nnz=16)`` (``sliced_lsq``); ``spmv_csr_sliced_prefetch`` on that
design with every 16th panel of 8 rows zeroed (``sliced_prefetch_holes``,
as ``chip_smoke.py`` builds it); ``spmv_ell`` on the SPD problem at its
exact width (``ell_spd``); ``spmv_csr`` on the SPD problem
(``segsum_spd``) and ``spmv_csr_prefetch`` on the zeroed design
(``segsum_prefetch_holes``).  Each turn times every case launched from
Python (the mean of ``REPS`` launches between two CUDA events, what a
solve pays) and replayed from one CUDA graph of ``REPS`` launches (the
card's time with the host's launch work taken out).

Digests: the SHA-256 of the output bytes of the timed cases and of
``DIGEST_KS`` x ``rows_per_panel`` 1 and 8 on ragged operators (3001 x
2500, rows of 0 to 70 or to 24 nonzeros: windows wider than two chunks of
lanes and narrower) through the sliced pair and ELL (exact and truncated
width, a slab of 700 rows of a 3001-column operator), bf16/i16
and bf16/i32 windows, and an x holding NaN, inf and -0 (both sliced
twins there, and the predicated one on the empty-panel design too); and
of the segment-sum pair on the same CSR operators and on ``panel0_layouts``
(panel 0 ending in a tail, filled exactly, empty) at ``DIGEST_KS``, on
bf16/i32, and for an x with NaN, inf and -0 in rows 0 and 1 (row 0's
tail term) and elsewhere, there and on the empty-panel design.  Checks
(exit 1 if one fails): each pair of twins bitwise equal (for that x past
row 0 where panel 0 is empty: its tail carries row 0 of x into the plain
segment sum only), the sliced kernel with counts bitwise equal to
without, and column 0 at k = 51 bitwise equal to k = 1.  Where the tree
under test takes the CSR row layout (``segsum_rows``), the segment sums
are given it.

Where the tree under test takes per-row counts (``counts``), the timed
cases pass what the operators' matvecs pass (``stop_counts``), and the
digested ones the operators' counts: their digests then hold the stopped
chains to a tree that chains every slot, and the probe also checks them
bitwise against its own runs without counts.

``--variants`` copies this tree's ``src/repro_torch`` to
``build/spmv_probe/<variant>/src``, patches the copy's
``csrc/common.cuh`` or ``kernels/spmv_csr.py`` and times its row-window
cases from a graph in a child process: ``gather_only`` adds each gathered
x value instead of its product (the same x rows gathered, no products:
wrong results, the gather floor); ``all_slots`` makes the stopped kernel
chain every slot of a row; ``stop_everywhere`` has the operators pass
their counts whatever their padding; ``early_return`` writes an empty
panel's zeros by an early return on the path without counts (the last
three give the same results).

``--gather-floor`` times the x gathers alone with a kernel of its own
(``GATHER_SOURCE``, built by ``nvcc`` into ``build/spmv_probe/gather/``;
nothing of ``csrc/``): one warp a gathered row of x, lanes on its
columns, a persistent grid, no window, count or output loads.  It gathers
the rows of x that the stored entries of the SPD CSR view, the ELL
operator, the LSQ design and its empty-panel variant (``holes``) name
(``ids``, one broadcast load of 4 bytes a row: the yardsticks of
``segsum_spd`` and ``segsum_prefetch_holes`` too), the same number of rows at hashed uniform ids (``hashed``, no id
loads) and in order (``in_order``), and reports each case's time from a
graph beside the 32-byte sectors its rows span and that rate: the card's
rate for these gathers, measured apart from the matvecs' layout.

``--padding-sweep`` times ``spmv_ell`` on the SPD problem at truncated
widths whose share of padding slots lies near ``SWEEP_PADDING`` (each
with its counts and without: the two kernels the operators choose
between at ``kernels/spmv_csr.py::STOP_PADDING_SHARE``).

Prints the card (``nvidia-smi``), then one JSON line.  To compare trees,
run this file with ``PYTHONPATH`` at each tree's ``src`` in turns
(parent, change, change, parent).  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import inspect
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core.kaczmarz import random_sparse_lsq
from repro_torch.core.operators import CsrOp, EllOp, as_operator
from repro_torch.core.spd import random_sparse_spd
from repro_torch.kernels import ops
from repro_torch.tune.table import card_name

ROOT = Path(__file__).resolve().parents[3]
K, REPS = 51, 50
DIGEST_KS = (1, 3, 16, 31, 32, 33, 51, 64, 70)
ROW_WINDOW_CASES = ("sliced_spd", "sliced_lsq", "sliced_prefetch_holes",
                    "ell_spd")

CUH, PY = "csrc/common.cuh", "kernels/spmv_csr.py"
VARIANTS = {
    "gather_only": [
        (CUH, "    for (int u = 0; u < 4; ++u) acc = fmaf(v[u], g[u], acc);",
         "    for (int u = 0; u < 4; ++u) acc += g[u];"),
        (CUH, "  for (; w < stop; ++w) acc = fmaf(to_f32(vr[w]), "
         "x[(size_t)(int)cr[w] * k + c], acc);",
         "  for (; w < stop; ++w) acc += x[(size_t)(int)cr[w] * k + c];")],
    "all_slots": [(CUH, "  return c < width ? c + 1 : width;\n",
                   "  return width;\n")],
    "stop_everywhere": [(PY, "STOP_PADDING_SHARE = 0.25\n",
                         "STOP_PADDING_SHARE = 0.0\n")],
    "early_return": [(CUH, """    y[t] = panel_nnz == nullptr || panel_nnz[r / rows_per_panel] > 0
               ? slot_dot(vals + (size_t)r * width, cols + (size_t)r * width, x, width, k, c)
               : 0.f;""", """    if (panel_nnz != nullptr && panel_nnz[r / rows_per_panel] == 0) {
      y[t] = 0.f;
      return;
    }
    y[t] = slot_dot(vals + (size_t)r * width, cols + (size_t)r * width, x, width, k, c);""")],
}


SWEEP_PADDING = (0.10, 0.18, 0.25, 0.30)

GATHER_SOURCE = r"""
// The x gathers of a row-window matvec alone: warp w of a persistent grid
// reads rows e = w, w + W, ... (W warps) of x (n, k) f32, lane l columns l
// and l + 32, four rows in flight; each lane adds what it read and writes
// its sum once, so no read is dead.  Row e is ids[e] (kIds: one broadcast
// load a warp), a hashed uniform id (kHashed), or e mod n (in order).
#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kIds = 0, kHashed = 1;

__device__ __forceinline__ unsigned mix(unsigned v) {
  v ^= v >> 16; v *= 0x7feb352du; v ^= v >> 15; v *= 0x846ca68bu; v ^= v >> 16;
  return v;
}

template <int kMode>
__device__ __forceinline__ const float* row_of(const int* __restrict__ ids, long long e,
                                               const float* __restrict__ x, int n, int k) {
  const int r = kMode == kIds ? __ldg(ids + e)
                : kMode == kHashed ? (int)(mix((unsigned)e) % (unsigned)n)
                                   : (int)(e % n);
  return x + (size_t)r * k;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const int* __restrict__ ids, long long rows, const float* __restrict__ x, int n,
                int k, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  float acc = 0.f;
  long long e = warp;
  for (; e + 3 * warps < rows; e += 4 * warps) {
    float g[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* row = row_of<kMode>(ids, e + u * warps, x, n, k);
      g[2 * u] = lane < k ? __ldg(row + lane) : 0.f;
      g[2 * u + 1] = lane + 32 < k ? __ldg(row + lane + 32) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += g[u];
  }
  for (; e < rows; e += warps) {
    const float* row = row_of<kMode>(ids, e, x, n, k);
    acc += lane < k ? __ldg(row + lane) : 0.f;
    acc += lane + 32 < k ? __ldg(row + lane + 32) : 0.f;
  }
  out[warp * 32 + lane] = acc;
}

// out holds grid * kThreads floats; k <= 64.
extern "C" int gather_rows_launch(const int* ids, long long rows, const float* x, int n, int k,
                                  int mode, float* out, int grid, cudaStream_t stream) {
  if (k > 64 || n <= 0) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    gather_rows<kIds><<<grid, kThreads, 0, stream>>>(ids, rows, x, n, k, out);
  else if (mode == 1)
    gather_rows<kHashed><<<grid, kThreads, 0, stream>>>(ids, rows, x, n, k, out);
  else
    gather_rows<2><<<grid, kThreads, 0, stream>>>(ids, rows, x, n, k, out);
  return (int)cudaGetLastError();
}
"""


def patched(sources: dict, variant: str) -> dict:
    """The variant's files (path under ``repro_torch/`` -> text) patched
    from ``sources``; raises if a file no longer holds exactly one copy of
    a line a patch expects."""
    out = dict(sources)
    for path, old, new in VARIANTS[variant]:
        if out[path].count(old) != 1:
            raise ValueError(f"{variant}: {path} does not hold exactly one "
                             f"{old.strip()[:60]!r}")
        out[path] = out[path].replace(old, new)
    return out


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
    ms = min(_ms(graph.replay) for _ in range(3)) / REPS
    del graph
    return ms


def _digest(y) -> str:
    return hashlib.sha256(y.contiguous().cpu().numpy().tobytes()).hexdigest()


def _holes(A):
    """A with every 16th panel of 8 rows zeroed (empty panels)."""
    A = A.clone()
    A.view(-1, 8, A.shape[1])[::16] = 0.0
    return A


def ragged_dense(m, n, gen, dev, most=70):
    """(m, n) with rows of 0 to ``most`` nonzeros at distinct random
    columns."""
    counts = torch.randint(0, most + 1, (m,), generator=gen, device=dev)
    cols = torch.rand((m, n), generator=gen, device=dev).argsort(1)[:, :most]
    keep = torch.arange(most, device=dev)[None, :] < counts[:, None]
    A = torch.zeros((m, n), device=dev)
    rows = torch.arange(m, device=dev)[:, None].expand(m, most)
    A[rows[keep], cols[keep]] = torch.randn(int(keep.sum()), generator=gen,
                                            device=dev)
    return A


COUNTS = "counts" in inspect.signature(ops.spmv_csr_sliced).parameters
ROWS = "row_start" in inspect.signature(ops.spmv_csr).parameters


def _counts(op, use, k):
    """The wrappers' counts where the tree takes them: ``"main"`` what the
    operator's matvec with k columns passes (``stop_counts``: None where
    its windows carry little padding), ``"rows"`` its per-row counts, None
    none."""
    if not COUNTS or use is None:
        return {}
    return {"counts": op.stop_counts(k) if use == "main"
            else op.row_counts()}


def _sliced(op, x, prefetch=False, counts="main"):
    vals, cols = op.sliced_rows()
    m, R = op.shape[0], op.rows_per_panel
    if prefetch:
        return functools.partial(ops.spmv_csr_sliced_prefetch, vals, cols,
                                 op.panel_nnz(), x, m=m, rows_per_panel=R,
                                 **_counts(op, counts, x.shape[1]))
    return functools.partial(ops.spmv_csr_sliced, vals, cols, x, m=m,
                             rows_per_panel=R,
                             **_counts(op, counts, x.shape[1]))


def _ell(op, x, counts="main", **kw):
    return functools.partial(ops.spmv_ell, op.vals, op.cols, x, **kw,
                             **_counts(op, counts, x.shape[1]))


def _segsum(op, x, prefetch=False):
    """The segment sum on ``op`` and ``x``, given the operator's row layout
    where the tree under test takes it (``segsum_rows``)."""
    kw = dict(m=op.shape[0], rows_per_panel=op.rows_per_panel,
              panel_width=op.panel_width,
              **(op.segsum_rows() if ROWS else {}))
    if prefetch:
        return functools.partial(ops.spmv_csr_prefetch, op.data, op.indices,
                                 op.row_id, op.panel_nnz(), x, **kw)
    return functools.partial(ops.spmv_csr, op.data, op.indices, op.row_id, x,
                             **kw)


def panel0_layouts(gen, dev, m, n, most=70, rest=24) -> dict:
    """CSR operators (m, n) f32 whose panel 0 ends in a tail of padding
    (``tail``), is filled exactly to the panel width (``exact``: lane 1)
    and holds no nonzero (``empty``), at rows_per_panel 1 and 8: panel 0's
    rows hold ``most`` nonzeros each, the others 0 to ``rest``, so panel 0
    sets the width.  Keyed ``R{R}_panel0_{kind}``."""
    A = ragged_dense(m, n, gen, dev, rest)
    out = {}
    for R in (1, 8):
        full = A.clone()
        full[:R] = 0.0
        cols = torch.rand((R, n), generator=gen, device=dev).argsort(1)
        full[torch.arange(R, device=dev)[:, None], cols[:, :most]] = \
            torch.randn((R, most), generator=gen, device=dev)
        empty = A.clone()
        empty[:R] = 0.0
        for kind, B, lane in (("tail", full, 128), ("exact", full, 1),
                              ("empty", empty, 128)):
            out[f"R{R}_panel0_{kind}"] = CsrOp.from_dense(
                B, rows_per_panel=R, lane=lane)
    return out


def _timed_cases(dev, only=None) -> dict:
    gen = torch.Generator(dev).manual_seed(0)
    spd = random_sparse_spd(16384, row_nnz=16, n_rhs=K, seed=0, device=dev)
    lsq = random_sparse_lsq(32768, 4096, row_nnz=16, n_rhs=K, seed=0,
                            device=dev)
    x_spd = torch.randn((16384, K), generator=gen, device=dev)
    x_lsq = torch.randn((4096, K), generator=gen, device=dev)
    csr_spd = as_operator(spd.A, "csr")
    holes = as_operator(_holes(lsq.A), "csr")
    ell = as_operator(spd.A, "ell")
    cases = {
        "sliced_spd": _sliced(csr_spd, x_spd),
        "sliced_lsq": _sliced(as_operator(lsq.A, "csr"), x_lsq),
        "sliced_prefetch_holes": _sliced(holes, x_lsq, prefetch=True),
        "ell_spd": _ell(ell, x_spd),
        "segsum_spd": _segsum(csr_spd, x_spd),
        "segsum_prefetch_holes": _segsum(holes, x_lsq, prefetch=True),
    }
    return {name: fn for name, fn in cases.items()
            if only is None or name in only}


def _digest_cases(dev) -> tuple[dict, list]:
    """name -> output of the cases only digested, and the checks' names
    that failed."""
    gen = torch.Generator(dev).manual_seed(1)
    wide = {most: ragged_dense(3001, 2500, gen, dev, most) for most in (70, 24)}
    sq = ragged_dense(3001, 3001, gen, dev)
    out, failed = {}, []
    ops_by = {(R, sd, most): CsrOp.from_dense(A, rows_per_panel=R,
                                              storage_dtype=sd)
              for R in (1, 8) for sd in (None, "bfloat16")
              for most, A in wide.items()}
    ells = {"ell_exact": EllOp.from_dense(sq), "ell_w24": EllOp.from_dense(
        sq, width=24), "ell_bf16": EllOp.from_dense(sq,
                                                    storage_dtype="bfloat16")}
    slab = EllOp.from_dense(ragged_dense(3001, 3001, gen, dev))
    for k in DIGEST_KS:
        x = torch.randn((2500, k), generator=gen, device=dev)
        xs = torch.randn((3001, k), generator=gen, device=dev)
        for (R, sd, most), op in ops_by.items():
            tag = f"R{R}_{'bf16' if sd else 'f32'}_nnz{most}_k{k}"
            y = _sliced(op, x, counts="rows")()
            yp = _sliced(op, x, prefetch=True, counts="rows")()
            out[f"sliced_{tag}"], out[f"sliced_prefetch_{tag}"] = y, yp
            if not torch.equal(y, yp):
                failed.append(f"sliced == sliced_prefetch, {tag}")
            if COUNTS and not torch.equal(y, _sliced(op, x, counts=None)()):
                failed.append(f"sliced with counts == without, {tag}")
        for name, op in ells.items():
            out[f"{name}_k{k}"] = y = _ell(op, xs, counts="rows")()
            if COUNTS and not torch.equal(y, _ell(op, xs, counts=None)()):
                failed.append(f"ell with counts == without, {name} k={k}")
        sv = slab.vals[1000:1700].contiguous()
        sc = slab.cols[1000:1700].contiguous()
        out[f"ell_slab_k{k}"] = ops.spmv_ell(
            sv, sc, xs, n_cols=3001,
            **({"counts": slab.row_counts()[1000:1700]} if COUNTS else {}))
    # x with NaN, inf and -0 in some rows: the chains' bits for any x
    x = torch.randn((2500, K), generator=gen, device=dev)
    x[3, 5], x[7, 0], x[11] = float("nan"), float("inf"), -0.0
    x[0] = -0.0                        # the sliced view's padding column
    lsq = random_sparse_lsq(32768, 4096, row_nnz=16, n_rhs=1, seed=0,
                            device=dev)
    holes = as_operator(_holes(lsq.A), "csr")
    xh = torch.randn((4096, K), generator=gen, device=dev)
    xh[0, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    xh[5, 7], xh[9] = float("-inf"), -0.0
    special = [(f"R{R}_{'bf16' if sd else 'f32'}_nnz{most}_special", op, x)
               for (R, sd, most), op in ops_by.items()]
    special.append(("holes_special", holes, xh))
    for tag, op, xz in special:
        if tag != "holes_special":
            out[f"sliced_{tag}"] = _sliced(op, xz, counts="rows")()
        out[f"sliced_prefetch_{tag}"] = _sliced(op, xz, prefetch=True,
                                                counts="rows")()
    xs = torch.randn((3001, K), generator=gen, device=dev)
    xs[:100] = -0.0                    # rows of ELL padding columns too
    xs[200, 3] = float("nan")
    out["ell_exact_special"] = _ell(ells["ell_exact"], xs, counts="rows")()
    # bf16 values with int32 indices (n > 32767), as chip_smoke.py builds
    n_big = 40000
    offs = torch.tensor([0, 1, 977, 20011, 39999], device=dev)
    rows = torch.arange(n_big, device=dev)
    row_cols = ((rows[:, None] + offs[None, :]) % n_big).to(torch.int32)
    row_vals = torch.randn((n_big, 5), generator=gen, device=dev) * 0.2
    big = CsrOp._assemble(row_vals.to(torch.bfloat16), row_cols, [5] * n_big,
                          shape=(n_big, n_big))
    xb = torch.randn((n_big, 4), generator=gen, device=dev)
    out["sliced_bf16_i32"] = _sliced(big, xb, counts="rows")()
    out["sliced_prefetch_bf16_i32"] = _sliced(big, xb, prefetch=True,
                                              counts="rows")()
    bv, bc = big.padded_rows()
    out["ell_bf16_i32"] = ops.spmv_ell(
        bv, bc, xb, **({"counts": big.row_counts()} if COUNTS else {}))
    # column 0 at k = 51 against k = 1
    for (R, sd, most), op in ops_by.items():
        x51 = torch.randn((2500, K), generator=gen, device=dev)
        x1 = x51[:, :1].contiguous()
        for pre in (False, True):
            if not torch.equal(_sliced(op, x51, pre, "rows")()[:, 0],
                               _sliced(op, x1, pre, "rows")()[:, 0]):
                failed.append(f"column 0 at k={K} == k=1, R{R} {sd} {most} "
                              f"{pre}")
    failed += _segsum_digests(ops_by, big, xb, dev, out)
    return out, failed


def _segsum_digests(ops_by, big, xb, dev, out) -> list:
    """Adds to ``out`` the segment sums' outputs on the ragged operators
    and ``panel0_layouts`` at ``DIGEST_KS``, on the bf16/i32 operator, and
    for an x with NaN, inf and -0 (rows 0 and 1 among them: row 0's tail
    term) on those and on the empty-panel design; returns the checks that
    failed: the twins bitwise equal (for that x only where panel 0 holds
    a nonzero, and past row 0 everywhere) and column 0 at k = 51 bitwise
    k = 1.  Draws from a generator of its own."""
    gen = torch.Generator(dev).manual_seed(2)
    seg = {f"R{R}_{'bf16' if sd else 'f32'}_nnz{most}": op
           for (R, sd, most), op in ops_by.items()}
    seg.update(panel0_layouts(gen, dev, 3001, 2500))
    failed = []

    def both(tag, op, x):
        y, yp = _segsum(op, x)(), _segsum(op, x, prefetch=True)()
        out[f"segsum_{tag}"], out[f"segsum_prefetch_{tag}"] = y, yp
        return y, yp

    for k in DIGEST_KS:
        x = torch.randn((2500, k), generator=gen, device=dev)
        for name, op in seg.items():
            y, yp = both(f"{name}_k{k}", op, x)
            if not torch.equal(y, yp):
                failed.append(f"segsum == segsum_prefetch, {name} k={k}")
    y, yp = both("bf16_i32", big, xb)
    if not torch.equal(y, yp):
        failed.append("segsum == segsum_prefetch, bf16/i32")
    x = torch.randn((2500, K), generator=gen, device=dev)
    x[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             -0.0])
    x[0, 4:8] = 0.0
    x[1, :3] = torch.tensor([-0.0, float("nan"), float("inf")])
    x[3, 5], x[7, 0], x[11] = float("nan"), float("inf"), -0.0
    lsq = random_sparse_lsq(32768, 4096, row_nnz=16, n_rhs=1, seed=0,
                            device=dev)
    xh = torch.randn((4096, K), generator=gen, device=dev)
    xh[:2] = x[:2]
    cases = [(name, op, x) for name, op in seg.items()]
    cases.append(("holes", as_operator(_holes(lsq.A), "csr"), xh))
    for name, op, xz in cases:
        y, yp = both(f"{name}_special", op, xz)
        lo = 0 if int(op.panel_nnz()[0]) > 0 else 1
        if not torch.equal(y.view(torch.int32)[lo:],
                           yp.view(torch.int32)[lo:]):
            failed.append(f"segsum == segsum_prefetch bitwise, {name}, x "
                          "with NaN/inf/-0")
    for name, op in seg.items():
        x51 = torch.randn((2500, K), generator=gen, device=dev)
        x1 = x51[:, :1].contiguous()
        for pre in (False, True):
            if not torch.equal(_segsum(op, x51, pre)()[:, 0],
                               _segsum(op, x1, pre)()[:, 0]):
                failed.append(f"segsum column 0 at k={K} == k=1, {name} "
                              f"{pre}")
    return failed


def _stored_ids(vals, cols, counts):
    """The column ids of the stored entries of (rows, width) windows, row
    by row in slot order: the rows of x a matvec must gather."""
    slot = torch.arange(vals.shape[1], device=vals.device)[None, :]
    return cols[:counts.numel()][slot < counts[:, None]].to(torch.int32)


def _hashed_rows(count, n, dev):
    """The rows ``GATHER_SOURCE``'s ``mix`` picks for e = 0 .. count - 1."""
    mask = 0xFFFFFFFF
    v = torch.arange(count, device=dev, dtype=torch.int64)
    v ^= v >> 16
    v = (v * 0x7FEB352D) & mask
    v ^= v >> 15
    v = (v * 0x846CA68B) & mask
    v ^= v >> 16
    return v % n


def _sectors(ids, k) -> int:
    """32-byte sectors spanned by the gathered rows of an (n, k) f32 x."""
    start = ids.long() * (4 * k)
    return int(((start + 4 * k - 1) // 32 - start // 32 + 1).sum())


def _gather_launcher():
    """The ``GATHER_SOURCE`` launcher, built by ``nvcc`` with the port's
    flags."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "spmv_probe" / "gather"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "gather.cu", out / "gather.so"
    src.write_text(GATHER_SOURCE)
    run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc gather.cu:\n{run.stdout}{run.stderr}")
    fn = ctypes.CDLL(str(lib)).gather_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def _gather_floor(dev) -> dict:
    """Graph ms of the x gathers alone (``GATHER_SOURCE``) for the stored
    entries of the main row-window operators, and the sectors they span."""
    launch = _gather_launcher()
    gen = torch.Generator(dev).manual_seed(0)
    spd = random_sparse_spd(16384, row_nnz=16, n_rhs=K, seed=0, device=dev)
    lsq = random_sparse_lsq(32768, 4096, row_nnz=16, n_rhs=K, seed=0,
                            device=dev)
    x_spd = torch.randn((16384, K), generator=gen, device=dev)
    x_lsq = torch.randn((4096, K), generator=gen, device=dev)
    csr_spd, csr_lsq = as_operator(spd.A, "csr"), as_operator(lsq.A, "csr")
    holes = as_operator(_holes(lsq.A), "csr")
    ell = as_operator(spd.A, "ell")
    grid = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    out = torch.empty(grid * 256, device=dev)
    cases = {
        "sliced_spd": (_stored_ids(*csr_spd.sliced_rows(),
                                   csr_spd.row_counts()), x_spd),
        "ell_spd": (_stored_ids(ell.vals, ell.cols, ell.row_counts()), x_spd),
        "sliced_lsq": (_stored_ids(*csr_lsq.sliced_rows(),
                                   csr_lsq.row_counts()), x_lsq),
        "holes": (_stored_ids(*holes.sliced_rows(), holes.row_counts()),
                  x_lsq),
    }
    res = {}
    for name, (ids, x) in cases.items():
        n, k = x.shape
        for mode, label in enumerate(("ids", "hashed", "in_order")):
            def run(ids=ids, x=x, mode=mode):
                err = launch(ids.data_ptr(), ids.numel(), x.data_ptr(), n, k,
                             mode, out.data_ptr(), grid,
                             torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"gather_rows_launch: CUDA error {err}")
            ms = _graph_ms(run)
            rows = (ids, _hashed_rows(ids.numel(), n, dev),
                    torch.arange(ids.numel(), device=dev) % n)[mode]
            sectors = _sectors(rows, k)
            res[f"{name}_{label}"] = {
                "rows": ids.numel(), "graph_ms": ms, "sectors": sectors,
                "sector_tb_per_s": sectors * 32 / (ms * 1e-3) / 1e12}
    return res


def _padding_sweep(dev) -> dict:
    """Graph ms of ``spmv_ell`` on the SPD problem at truncated widths
    whose padding share lies near each ``SWEEP_PADDING``, with its counts
    and without."""
    gen = torch.Generator(dev).manual_seed(0)
    spd = random_sparse_spd(16384, row_nnz=16, n_rhs=K, seed=0, device=dev)
    x = torch.randn((16384, K), generator=gen, device=dev)
    c = as_operator(spd.A, "ell").row_counts().long()
    n, res = c.numel(), {}
    widths = torch.arange(1, int(c.max()) + 1, device=dev)
    share = 1 - torch.minimum(c[None, :], widths[:, None]).sum(1) / (
        n * widths)
    for target in SWEEP_PADDING:
        w = int(widths[(share - target).abs().argmin()])
        if f"w{w}" in res:
            continue
        op = EllOp.from_dense(spd.A, width=w)
        slots = op.vals.numel()
        y_stop, y_all = _ell(op, x, "rows")(), _ell(op, x, None)()
        res[f"w{w}"] = {
            "width": w,
            "padding_share": (slots - int(op.row_counts().sum())) / slots,
            "counts_graph_ms": _graph_ms(_ell(op, x, "rows")),
            "no_counts_graph_ms": _graph_ms(_ell(op, x, None)),
            "bitwise_equal": bool(torch.equal(y_stop, y_all)),
            "operator_stops": op.stop_counts(K) is not None}
    return res


def _child(only) -> dict:
    """Runs on a patched copy: graph ms of the row-window cases."""
    cases = _timed_cases("cuda", only)
    return {name: _graph_ms(fn) for name, fn in cases.items()}


def _variant(name: str) -> dict:
    pkg = ROOT / "src" / "repro_torch"
    sources = {path: (pkg / path).read_text() for path in (CUH, PY)}
    dst = ROOT / "build" / "spmv_probe" / name
    shutil.rmtree(dst / "src", ignore_errors=True)
    shutil.copytree(pkg, dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, text in patched(sources, name).items():
        (dst / "src" / "repro_torch" / path).write_text(text)
    env = dict(os.environ, PYTHONPATH=str(dst / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune.spmv_probe", "--child"],
        env=env, cwd=ROOT, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"variant {name}:\n{run.stdout}{run.stderr}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--variants", default="")
    ap.add_argument("--gather-floor", action="store_true")
    ap.add_argument("--padding-sweep", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(ROW_WINDOW_CASES)))
        return 0
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    cases = _timed_cases("cuda")
    turns = []
    for _ in range(args.turns):
        turns.append({name: {"ms": _ms(fn), "graph_ms": _graph_ms(fn)}
                      for name, fn in cases.items()})
    digests = {name: _digest(fn()) for name, fn in cases.items()}
    more, failed = _digest_cases("cuda")
    digests.update({name: _digest(y) for name, y in more.items()})
    variants = {name: _variant(name) for name in names}
    extra = {}
    if args.gather_floor:
        extra["gather_floor"] = _gather_floor("cuda")
    if args.padding_sweep:
        extra["padding_sweep"] = _padding_sweep("cuda")
        failed += [f"padding sweep {w}: with counts == without"
                   for w, r in extra["padding_sweep"].items()
                   if not r["bitwise_equal"]]
    card = card_name()
    print(card)
    print(json.dumps({"label": args.label, "k": K, "reps": REPS,
                      "turns": turns, "variants": variants, **extra,
                      "digests": digests, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
