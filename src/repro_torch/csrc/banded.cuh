// Band-tile products of the banded sweeps (banded_gs.cu: the GS and RK
// sweeps).  bbmv.cu has its own register-tiled, double-buffered product
// and does not use band_part.
//
// A CTA of kBandThreads threads owns `block` rows x `kt` columns of
// outputs, at most kBandThreads * OPT of them, OPT per thread: output
// o = threadIdx.x + q * kBandThreads (q < OPT) is row o / kt, column o % kt
// of the CTA's tile.  band_part computes, for each owned output, the
// product of one (block, block) band tile with one (block, k) block of x:
//   part[q] = sum_j tile[r, j] * x[j, c0 + c]    (fmaf, j = 0, 1, ... in order)
// The tile and the x block are staged through shared memory kChunk tile
// columns at a time (tile rows padded to kChunk + 1 floats, so the threads
// of a warp that read one column of different rows hit distinct banks);
// bf16 tiles widen to f32 as they are staged.  The sum over j is carried
// across chunks in the same order, so an output's value depends only on its
// row of the tile and its column of x: not on kt, k or the launch shape.
//
// The staging loads are what the banded sweep waits on: one CTA per SM
// steps through 20 chunks per pick (block 128, bands 2), each a round trip
// to L2.  A full chunk is therefore staged with no division in its index
// arithmetic and eight loads per thread in flight; on an H100 80GB HBM3
// at 700 W that halved the sweep's time against one load at a time, while
// staging whole chunks into register arrays (more registers, fewer CTAs
// per SM) made the sweep and the first bbmv slower (PERF.md).
#pragma once

#include "common.cuh"

namespace {

constexpr int kBandThreads = 256;
constexpr int kChunk = 32;  // tile columns staged per pass
constexpr int kMaxTileCols = 64;

// Columns per CTA for OPT outputs per thread.  The wrappers (kernels/ops.py)
// pass block <= 256, so kt >= 1 and one CTA's shared memory stays under the
// 48 KB a launch gets without opting in (at most 36 KB with the banded RK
// sweep's block x kt floats of gn: block 256, kt 2).
inline int band_tile_cols(int block, int k, int opt) {
  int kt = kBandThreads * opt / block;
  kt = kt < kMaxTileCols ? kt : kMaxTileCols;
  return kt < k ? kt : k;
}

// Dynamic shared memory of one CTA: the tile chunk, then the x chunk.
inline size_t band_smem_bytes(int block, int kt) {
  return sizeof(float) * ((size_t)block * (kChunk + 1) + (size_t)kChunk * kt);
}

// Every thread of the CTA must call this (it synchronises the block).
// `xblk` points at row 0 of the x block (row stride k); c0 is the CTA's
// first column, kt its column count.
template <typename V, int OPT>
__device__ __forceinline__ void band_part(const V* __restrict__ tile, const float* xblk, int block,
                                          int k, int c0, int kt, float* As, float* Xs,
                                          float (&part)[OPT]) {
  const int outputs = block * kt;
#pragma unroll
  for (int q = 0; q < OPT; ++q) part[q] = 0.f;
  for (int j0 = 0; j0 < block; j0 += kChunk) {
    const int jc = block - j0 < kChunk ? block - j0 : kChunk;
    __syncthreads();  // the previous chunk's readers are done with As/Xs
    if (jc == kChunk) {
      // A full chunk: thread t stages column t % kChunk of every
      // (kBandThreads / kChunk)-th row, with no division in the index
      // arithmetic, and the unrolled loop keeps several loads in flight.
      const int j = threadIdx.x % kChunk;
#pragma unroll 8
      for (int r = threadIdx.x / kChunk; r < block; r += kBandThreads / kChunk)
        As[r * (kChunk + 1) + j] = to_f32(tile[(size_t)r * block + j0 + j]);
    } else {
      for (int e = threadIdx.x; e < block * jc; e += kBandThreads) {
        const int r = e / jc, j = e - r * jc;
        As[r * (kChunk + 1) + j] = to_f32(tile[(size_t)r * block + j0 + j]);
      }
    }
    for (int e = threadIdx.x; e < jc * kt; e += kBandThreads) {
      const int j = e / kt, c = e - j * kt;
      Xs[j * kt + c] = xblk[(size_t)(j0 + j) * k + c0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      const int o = threadIdx.x + q * kBandThreads;
      if (o < outputs) {
        const int r = o / kt, c = o - r * kt;
        const float* ar = As + r * (kChunk + 1);
        float s = part[q];
        for (int j = 0; j < jc; ++j) s = fmaf(ar[j], Xs[j * kt + c], s);
        part[q] = s;
      }
    }
  }
}

}  // namespace
