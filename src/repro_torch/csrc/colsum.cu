// Column sums of a row-major (n, k) f32 tensor: out[c] = sum_i t[i, c].
//
// A kernel of the port's own, with no TPU counterpart: the reference sums
// its records with jnp (src/repro/core/engine.py::record_metrics, an einsum
// and a norm over axis 0), outside any Pallas kernel.  It replaces torch.sum
// in the port's record sums (core/engine.py::record_metrics, the
// distributed engine's metrics), because torch.sum on the card picks its
// thread split from the number of outputs (ATen/native/cuda/Reduce.cuh,
// setReduceConfig): at k = 1 a column was summed in another order than at
// k = 51, so err_sq and resid of a zero-padded RHS column differed from the
// solo column's (DESIGN.md §8 asks them to be bitwise equal).
//
// The order is fixed by n and `slices` alone, never by k; the launcher
// (kernels/colsum.py) takes `slices` from n only.  Two kernels, in place
// on the (n, k) tensor (no transposed copy):
//  1. colsum_slices: the rows are cut into `slices` runs of
//     ceil(n / slices); a CTA takes one run and 32 adjacent columns, lane l
//     of warp w column 32 * blockIdx.y + l and rows w, w + kWarps, ... of
//     the run in row order, so a warp's loads are one coalesced row
//     segment.  A fixed tree in shared memory combines the kWarps partial
//     sums of a column, and the run's sum goes to ws[slice, c].
//  2. colsum_finish: one warp a column; lane l adds ws[l, c],
//     ws[l + 32, c], ... in order, then the butterfly combines the lanes.
// Every add is rounded on its own (__fadd_rn), so nothing depends on
// contraction either.
//
// What bounds it: n * k * 4 bytes read once, 3.3 MB at the main path's
// n = 16384, k = 51, or 1 us at the memory's rate; its time per call is in
// PERF.md.
//
// The C entry launches both kernels on the caller's stream and returns
// cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps of a colsum_slices CTA
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps)
    colsum_slices(const float* __restrict__ t, float* __restrict__ ws, int n, int k, int run) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  const int lo = blockIdx.x * run;
  const int hi = min(n, lo + run);
  float acc = 0.f;
  if (c < k) {
#pragma unroll 4
    for (int row = lo + warp; row < hi; row += kWarps)
      acc = __fadd_rn(acc, t[(size_t)row * k + c]);
  }
  part[warp][lane] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kWarps / 2; half > 0; half >>= 1) {
    if (warp < half) part[warp][lane] = __fadd_rn(part[warp][lane], part[warp + half][lane]);
    __syncthreads();
  }
  if (warp == 0 && c < k) ws[(size_t)blockIdx.x * k + c] = part[0][lane];
}

__global__ void colsum_finish(const float* __restrict__ ws, float* __restrict__ out, int k,
                              int slices) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= k) return;  // warp-uniform
  float acc = 0.f;
  for (int s = lane; s < slices; s += 32) acc = __fadd_rn(acc, ws[(size_t)s * k + c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
  if (lane == 0) out[c] = acc;
}

}  // namespace

// ws: (slices, k) f32 scratch; slices >= 1, a function of n alone.
extern "C" int colsum_f32(const void* t, void* ws, void* out, int n, int k, int slices,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int run = (n + slices - 1) / slices;
  colsum_slices<<<dim3(slices, (k + 31) / 32), 32 * kWarps, 0, s>>>((const float*)t, (float*)ws,
                                                                    n, k, run);
  constexpr int kFinishWarps = 8;
  colsum_finish<<<(k + kFinishWarps - 1) / kFinishWarps, 32 * kFinishWarps, 0, s>>>(
      (const float*)ws, (float*)out, k, slices);
  return (int)cudaGetLastError();
}
