// Block-banded matvec: y_i = sum_d A_bands[i, d] @ x[block i + d - bands].
//
// Replaces the TPU kernel src/repro/kernels/bbmv.py::bbmv (one grid step
// per block row, the 2*bands+1 tiles fed to the MXU, out-of-range block
// columns masked to zero).  Inputs: tiles A_bands (nb, 2*bands+1, block,
// block) f32 or bf16, x (nb*block, k) f32; output y (nb*block, k) f32.
//
// What bounds it.  At the main path's shapes (nb = 128, block = 128,
// bands = 2, k = 51) about 42 MB of tiles and 2*block*k flops per tile
// element: 1.06 GFLOP against 42 MB, so the f32 rate (no tensor cores:
// the port's precision contract keeps IEEE f32, not TF32) and the tile
// bytes bound it about equally (about 16 us on an H100).  This kernel
// takes about 12 times that: its CTAs wait on the latency of their staging
// loads, and its time followed the number of CTAs resident per SM when a
// variant with more registers halved it (PERF.md).
//
// Design.  One CTA per (block row i, tile of kt columns).  For each band d
// in order whose block column lies inside the matrix (the others are
// skipped, never read), band_part (banded.cuh) stages the tile and the x
// block through shared memory and every thread forms the band's partial
// sums for its outputs; the partials are added band by band.  So each
// output is summed by one thread in a fixed order (band d, then tile
// column j), and a column's result does not depend on how many columns
// ride along.  Plain fmaf on CUDA cores; wgmma/TMA are later work.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "banded.cuh"

namespace {

constexpr int kOpt = 8;  // outputs per thread

template <typename V>
__global__ void __launch_bounds__(kBandThreads)
    bbmv_kernel(const V* __restrict__ A, const float* __restrict__ x, float* __restrict__ y, int nb,
                int bands, int block, int k, int kt) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Xs = smem + block * (kChunk + 1);
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * kt;
  const int ktile = k - c0 < kt ? k - c0 : kt;
  const int width = 2 * bands + 1;
  float acc[kOpt];
#pragma unroll
  for (int q = 0; q < kOpt; ++q) acc[q] = 0.f;
  for (int d = 0; d < width; ++d) {
    const int jb = i + d - bands;
    if (jb < 0 || jb >= nb) continue;  // uniform over the CTA
    float part[kOpt];
    band_part<V, kOpt>(A + ((size_t)i * width + d) * block * block, x + (size_t)jb * block * k,
                       block, k, c0, ktile, As, Xs, part);
#pragma unroll
    for (int q = 0; q < kOpt; ++q) acc[q] += part[q];
  }
#pragma unroll
  for (int q = 0; q < kOpt; ++q) {
    const int o = threadIdx.x + q * kBandThreads;
    if (o < block * ktile) {
      const int r = o / ktile, c = o - r * ktile;
      y[((size_t)i * block + r) * k + c0 + c] = acc[q];
    }
  }
}

}  // namespace

#define BBMV_ENTRY(NAME, V)                                                                    \
  extern "C" int NAME(const void* A, const void* x, void* y, int nb, int bands, int block,    \
                      int k, void* stream) {                                                   \
    const int kt = band_tile_cols(block, k, kOpt);                                             \
    const dim3 grid((unsigned)nb, (unsigned)((k + kt - 1) / kt));                              \
    bbmv_kernel<V><<<grid, kBandThreads, band_smem_bytes(block, kt), (cudaStream_t)stream>>>( \
        (const V*)A, (const float*)x, (float*)y, nb, bands, block, k, kt);                    \
    return (int)cudaGetLastError();                                                            \
  }

BBMV_ENTRY(bbmv_f32, float)
BBMV_ENTRY(bbmv_bf16, __nv_bfloat16)
