"""Time the CSR block-GS sweep on the main path's chunk beside its chain
floor, and print digests of its outputs, so that two versions of
``csrc/sweep_csr.cu`` can be compared for speed and bitwise in one call.

    PYTHONPATH=src python -m repro_torch.tune.csr_block_gs_probe
        [--label C] [--repeats 5] [--floor] [--blocks 8,128]
        [--variant b_all_lanes_spin]

The problem is ``random_sparse_spd(16384, row_nnz=16)`` (seed 0) in CSR,
its padded rows (width 51) stored f32/i32 and bf16/i16; b from the
problem, x random (seed 0 on the card), and from the same generator one
chunk of ``n // block`` panel ids (a sweep) at each block of ``--blocks``
(default ``BLOCKS``).
Cases ``<f32|bf16>_b<block>_k<51|1>_<shared|global>``: the chunk through
the bare launcher (``kernels/sweep_csr.py``) on each path, replayed from
one CUDA graph of ``REPS`` launches (min of ``--repeats`` replays).  Per
case: ms a launch and the SHA-256 of the output.  Checks (exit 1 if one
fails): the two paths bitwise equal, column 0 at k = 51 bitwise column 0
at k = 1, and the first ``PREFIX`` picks within ``SWEEP_RTOL`` (rel
||dx||) of the plain version (``kernels/ref.py``).  Also the chunk's byte
bound (each picked row's stored nonzeros, value and id, its b row, the
ids, x in and out, ``roofline.sweep_rows_block_gs``) over the card's
memory rate (``roofline.PEAKS``).

``--floor`` builds ``FLOOR_SOURCE`` (``nvcc``, into
``build/csr_block_gs_probe/``) and times the chain floor of each block
whose pick is one tile, at k = 51 on the launcher's plan (``block_plan``):
the ring kernel's pick loop with its synchronization (a stage wait, a
stage release, the two points of order) and one dependent shared-memory
gather and butterfly a pick, no window loads and no arithmetic beyond
that.

``--variant`` copies this tree's ``src`` to
``build/csr_block_gs_probe/<variant>/src``, patches the block sweep's
source there (never the tree's own) and runs this probe on the copy,
with the other arguments.  ``b_all_lanes``: the producer's lanes 0-31
all copy b (lane j rows j, j + 32, ...; lane 0 before its proxy fence
and bulk copies); ``spin``: a late stage's wait spins on ``try_wait``
with no suspend-time hint; ``b_all_lanes_spin``: both; ``stages3``: a
ring of three stages (``kRingStages``, ``RING_STAGES``).  None moves the
results' bits.

Prints the card (``nvidia-smi``), then one JSON line.  To compare trees,
run this file with ``PYTHONPATH`` at each tree's ``src`` in turns (parent,
change, change, parent) and compare the digests.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch import roofline
from repro_torch.core.operators import as_operator
from repro_torch.core.spd import random_sparse_spd
from repro_torch.kernels import ref, sweep_csr
from repro_torch.tune.table import card_name

ROOT = Path(__file__).resolve().parents[3]
N, K, ROW_NNZ = 16384, 51, 16
BLOCKS = (8, 128)
BETA = 0.9
REPS = 10
PREFIX = 64
SWEEP_RTOL = 1e-5

FLOOR_SOURCE = r"""
// The chain floor of the CSR block-GS ring kernel (csrc/sweep_csr.cu): its
// CTA shape (warps consumer warps, lanes lanes a row, one idle warp in the
// producer's place), its pick loop with its synchronization (a wait on a
// stage barrier that has completed, a release by lane 0 of each warp,
// the two points of order: __syncwarp for one warp, bar.sync 1 for more)
// and, a pick, one shared-memory gather of x that the previous pick's
// writes reach and the butterfly of a row's lanes.  No window loads, no
// arithmetic beyond that.  One CTA a column, x[0:n, c] in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void consumers_sync(int warps) {
  if (warps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(32 * warps) : "memory");
}

template <int kLanes>
__global__ void __launch_bounds__(288)
    floor_kernel(const int* __restrict__ picks, float* x, int n, int k, int steps, int block,
                 int warps) {
  __shared__ __align__(8) uint64_t bars[2];
  extern __shared__ float xs[];
  const int c = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = lane % kLanes, jt = warp * (32 / kLanes) + lane / kLanes;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bars[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(&bars[1])), "r"(warps)
                 : "memory");
    asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
                     smem_u32(&bars[0]))
                 : "memory");
  }
  for (int row = threadIdx.x; row < n; row += blockDim.x) xs[row] = x[(size_t)row * k + c];
  __syncthreads();
  if (warp < warps) {
    const bool active = jt < block;
    int ids = lane < steps ? picks[lane] : 0;
    int next = 32 + lane < steps ? picks[32 + lane] : 0;
    for (int s = 0; s < steps; ++s) {
      if (s % 32 == 0 && s > 0) {
        ids = next;
        next = s + 32 + lane < steps ? picks[s + 32 + lane] : 0;
      }
      const int row = __shfl_sync(0xffffffffu, ids, s % 32) * block + jt;
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_u32(&bars[0]))
            : "memory");
      float v = active ? xs[(row + 1 + i) % n] : 0.f;
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      __syncwarp();
      if (lane == 0)
        asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
                         smem_u32(&bars[1]))
                     : "memory");
      consumers_sync(warps);
      if (active && i == 0) xs[row] = v;
      consumers_sync(warps);
    }
  }
  __syncthreads();
  for (int row = threadIdx.x; row < n; row += blockDim.x) x[(size_t)row * k + c] = xs[row];
}

template <int kLanes>
int launch(const void* picks, void* x, int n, int k, int steps, int block, int warps,
           cudaStream_t s) {
  const int bytes = (int)(sizeof(float) * (size_t)n);
  const cudaError_t err = cudaFuncSetAttribute(
      floor_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  floor_kernel<kLanes><<<k, 32 * (warps + 1), bytes, s>>>((const int*)picks, (float*)x, n, k,
                                                          steps, block, warps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chain_floor(const void* picks, void* x, int n, int k, int steps, int block,
                           int lanes, int warps, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch<1>(picks, x, n, k, steps, block, warps, s);
    case 2: return launch<2>(picks, x, n, k, steps, block, warps, s);
    case 4: return launch<4>(picks, x, n, k, steps, block, warps, s);
    default: return launch<32>(picks, x, n, k, steps, block, warps, s);
  }
}
"""


_PRODUCER_B = """\
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          const uint32_t bv = (uint32_t)((mv - av) * sizeof(V));
          const uint32_t bc = (uint32_t)((mc - ac) * sizeof(I));
          mbar_arrive_tx(fb, bv + bc);
          if (bv) bulk_load(smem_u32(sv), vals + av, bv, fb);
          if (bc) bulk_load(smem_u32(sc), cols + ac, bc, fb);
        } else {
          for (int j = lane - 1; j < rows; j += 31)
            async_copy4(smem_u32(&sb[j]), &b[(row0 + t0 + j) * k + c]);
          async_copies_arrive(fb);
          if (lane < 16) {"""
_SPIN = [
    ("csrc/sweep_csr.cu",
     '"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\\n\\t"',
     '"mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n\\t"'),
    ("csrc/sweep_csr.cu", ': "r"(bar), "r"(parity), "r"(1000000u)',
     ': "r"(bar), "r"(parity)'),
]
_B_ALL_LANES = [("csrc/sweep_csr.cu", _PRODUCER_B, """\
        for (int j = lane; j < rows; j += 32)
          async_copy4(smem_u32(&sb[j]), &b[(row0 + t0 + j) * k + c]);
        async_copies_arrive(fb);
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          const uint32_t bv = (uint32_t)((mv - av) * sizeof(V));
          const uint32_t bc = (uint32_t)((mc - ac) * sizeof(I));
          mbar_arrive_tx(fb, bv + bc);
          if (bv) bulk_load(smem_u32(sv), vals + av, bv, fb);
          if (bc) bulk_load(smem_u32(sc), cols + ac, bc, fb);
        } else {
          if (lane < 16) {""")]
# name -> (file under src/repro_torch, old, new) patches
VARIANTS = {
    "spin": _SPIN,
    "b_all_lanes": _B_ALL_LANES,
    "b_all_lanes_spin": _B_ALL_LANES + _SPIN,
    "stages3": [("csrc/sweep_csr.cu", "constexpr int kRingStages = 2;",
                 "constexpr int kRingStages = 3;"),
                ("kernels/sweep_csr.py", "RING_STAGES = 2 ",
                 "RING_STAGES = 3 ")],
}


def patched(sources: dict, variant: str) -> dict:
    """``sources`` (file under ``src/repro_torch`` -> text) with the
    variant's changes; raises if a file no longer holds exactly one of the
    lines a patch expects."""
    out = dict(sources)
    for name, old, new in VARIANTS[variant]:
        if out[name].count(old) != 1:
            raise ValueError(f"{variant}: {name} does not hold exactly one "
                             f"{old[:50]!r}")
        out[name] = out[name].replace(old, new)
    return out


def _run_variant(variant: str, argv) -> int:
    """This probe, with ``argv``, on a copy of the tree patched by
    ``variant``; its output passes through."""
    dst = ROOT / "build" / "csr_block_gs_probe" / variant
    shutil.rmtree(dst / "src", ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = dst / "src/repro_torch"
    names = {name for name, _, _ in VARIANTS[variant]}
    for name, text in patched({name: (pkg / name).read_text()
                               for name in names}, variant).items():
        (pkg / name).write_text(text)
    env = dict(os.environ, PYTHONPATH=str(dst / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tune.csr_block_gs_probe", *argv],
        env=env, cwd=ROOT).returncode


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--blocks", default=",".join(map(str, BLOCKS)),
                    help="comma-separated blocks to time")
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="run on a patched copy of csrc/sweep_csr.cu")
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    return args


def _graph_ms(fn, repeats: int) -> float:
    """Min over ``repeats`` replays of one CUDA graph of ``REPS`` calls,
    ms a call (one warm-up call on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _problem(dev, blocks):
    """(operators by storage tag, b, x, chunk of panel ids by block)."""
    prob = random_sparse_spd(N, row_nnz=ROW_NNZ, n_rhs=K, seed=0, device=dev)
    ops_ = {"f32": as_operator(prob.A, "csr"),
            "bf16": as_operator(prob.A, "csr", storage_dtype="bfloat16")}
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn((N, K), generator=gen, device=dev)
    chunks = {blk: torch.randint(0, N // blk, (N // blk,), generator=gen,
                                 device=dev, dtype=torch.int32)
              for blk in blocks}
    return ops_, prob.b.contiguous(), x, chunks


def _bound_ms(op, picks, block: int) -> float:
    """The chunk's byte bound over the card's memory rate."""
    rows = (picks.long()[:, None] * block
            + torch.arange(block, device=picks.device)[None, :]).reshape(-1)
    vals, cols = op.padded_rows()
    work = roofline.sweep_rows_block_gs(
        float(op.row_nnz[rows].double().sum()), rows.numel(), picks.numel(),
        N, K, value_dtype=vals.dtype, index_dtype=cols.dtype)
    peaks = roofline.peaks(torch.cuda.get_device_name())
    return work.bytes / peaks.hbm_bytes_per_s * 1e3


def _floor_launcher():
    """``FLOOR_SOURCE``'s ``chain_floor``, built by ``nvcc`` with the
    port's flags."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "csr_block_gs_probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "floor.cu", out / "floor.so"
    src.write_text(FLOOR_SOURCE)
    run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc floor.cu:\n{run.stdout}{run.stderr}")
    fn = ctypes.CDLL(str(lib)).chain_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 6,
                   ctypes.c_void_p]
    return fn


def _floor(chunks, x, width: int, repeats: int) -> dict:
    """block -> ms of the chain floor a chunk, on the plan the launcher
    would take."""
    fn = _floor_launcher()
    cap = sweep_csr.shared_capacity(x.device)
    out = {}
    for blk, picks in chunks.items():
        plan = sweep_csr.block_plan(N, width, blk, 4, 4, cap)
        if plan.tile_rows < blk:
            continue                # the floor runs a pick in one pass
        xf = x.clone()

        def run(picks=picks, plan=plan, blk=blk, xf=xf):
            err = fn(picks.data_ptr(), xf.data_ptr(), N, K, picks.numel(),
                     blk, plan.lanes, plan.warps,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"chain_floor: CUDA error {err}")
        out[str(blk)] = {"ms": _graph_ms(run, repeats), "lanes": plan.lanes,
                    "warps": plan.warps}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.variant:
        argv = list(sys.argv[1:] if argv is None else argv)
        i = argv.index("--variant")
        return _run_variant(args.variant, argv[:i] + argv[i + 2:])
    dev = "cuda"
    blocks = [int(v) for v in args.blocks.split(",") if v]
    ops_, b, x, chunks = _problem(dev, blocks)
    cases, bounds, failed = {}, {}, []
    for tag, op in ops_.items():
        vals, cols = op.padded_rows()
        for blk, picks in chunks.items():
            outs = {}
            for k in (K, 1):
                bk, xk = b[:, :k].contiguous(), x[:, :k].contiguous()
                for shared in (True, False):
                    def run(vals=vals, cols=cols, bk=bk, xk=xk, blk=blk,
                            picks=picks, shared=shared):
                        return sweep_csr.sweep_rows_block_gs(
                            vals, cols, bk, xk, picks, block=blk, beta=BETA,
                            limit=N // blk, _shared=shared)
                    out = run()
                    name = (f"{tag}_b{blk}_k{k}_"
                            f"{'shared' if shared else 'global'}")
                    outs[(k, shared)] = out
                    cases[name] = {"ms": _graph_ms(run, args.repeats),
                                   "sha256": _digest(out)}
            where = f"{tag} block {blk}"
            if not torch.equal(outs[(K, True)], outs[(K, False)]):
                failed.append(f"{where}: the paths differ")
            if not torch.equal(outs[(K, True)][:, 0], outs[(1, True)][:, 0]):
                failed.append(f"{where}: column 0 at k={K} is not k=1")
            pre = picks[:PREFIX]
            got = sweep_csr.sweep_rows_block_gs(
                vals, cols, b, x, pre, block=blk, beta=BETA, limit=N // blk)
            want = ref.sweep_rows_block_gs_ref(vals, cols, b, x, pre,
                                               block=blk, beta=BETA)
            err = float((got - want).double().norm()
                        / want.double().norm())
            cases[f"{tag}_b{blk}_prefix"] = {"rel_err": err}
            if not err <= SWEEP_RTOL:
                failed.append(f"{where}: rel err {err:.3e} on {PREFIX} picks")
            if tag == "f32":
                bounds[str(blk)] = _bound_ms(op, picks, blk)
    result = {"label": args.label, "n": N, "k": K, "blocks": blocks,
              "cases": cases, "bound_ms": bounds, "failed": failed}
    if args.floor:
        width = ops_["f32"].padded_rows()[0].shape[1]
        result["floor"] = _floor(chunks, x, width, args.repeats)
    print(card_name())
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
