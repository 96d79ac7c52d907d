// Shared device helpers of the repro_torch kernels (sm_90a).
//
// Precision contract (DESIGN.md §4, KP1-4): coefficients may be stored as
// bf16 and column indices as int16; both are widened on load (bf16 -> f32
// by __bfloat162float, int16 -> int before any address arithmetic) and
// every product and sum accumulates in f32.
#pragma once

#include <cassert>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Butterfly sum over the 32 lanes of a warp.  Every lane ends with the same
// value: at each level lane i and lane i^o add the same two operands, and
// f32 addition is commutative.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row-window matvec (the CSR sliced-ELL view and ELL): y[r, c] =
// sum_w vals[r, w] * x[cols[r, w], c], one thread an output, one fmaf
// chain over the row's slots in slot order from +0, so a result depends
// neither on the launch shape nor on how many columns x has.  The design
// and what bounds it are in csrc/spmv_csr.cu's header note.
//
// Where a row's chain stops.  `counts` gives each row's count of slots
// before its padding, whose slots all hold the value +0 and one column
// (the operators' layouts: CSR row_nnz, ELL min(count, width)).  A padding slot applies g(a) = fmaf(+0, x[col, c],
// a) = a + p with one fixed p (a signed zero or NaN), and g(g(a)) == g(a)
// for every a, so the padding together applies g exactly once: the chain
// over slots [0, count], the first padding slot included, gives the bits
// of the chain over every slot, for any x (NaN, inf and -0 included).
constexpr int kRwThreads = 256;

__device__ __forceinline__ int rw_stop(const int* __restrict__ counts, int r, int width) {
  const int c = counts[r];
  return c < width ? c + 1 : width;
}

// acc = fmaf(vr[w], x[cr[w], c], acc) over slots [0, stop) in order.
template <typename V, typename I>
__device__ __forceinline__ float slot_dot(const V* __restrict__ vr, const I* __restrict__ cr,
                                          const float* __restrict__ x, int stop, int k, int c) {
  float acc = 0.f;
  for (int w = 0; w < stop; ++w) acc = fmaf(to_f32(vr[w]), x[(size_t)(int)cr[w] * k + c], acc);
  return acc;
}

// slot_dot with its first 4 slots' loads issued together ahead of the
// loop, so they overlap the load of the row's count that sets `stop`.
template <typename V, typename I>
__device__ __forceinline__ float slot_dot_peeled(const V* __restrict__ vr,
                                                 const I* __restrict__ cr,
                                                 const float* __restrict__ x, int stop, int k,
                                                 int c) {
  float acc = 0.f;
  int w = 0;
  if (stop >= 4) {
    float v[4], g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = to_f32(vr[u]);
      g[u] = x[(size_t)(int)cr[u] * k + c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = fmaf(v[u], g[u], acc);
    w = 4;
  }
  for (; w < stop; ++w) acc = fmaf(to_f32(vr[w]), x[(size_t)(int)cr[w] * k + c], acc);
  return acc;
}

// Thread t computes output (t / k, t % k) of rows [0, m) of (rows, width)
// windows; `panel_nnz` (or nullptr) writes zeros for the rows of empty
// panels.  kStop: each row stopped by `counts`, 32-bit indices (the
// wrappers keep m * k below 2^32); otherwise every slot, with the first
// port's loop, 64-bit indices and panel test (an early return there cost
// the LSQ design 16-17% on an H100).
template <typename V, typename I, bool kStop>
__global__ void __launch_bounds__(kRwThreads)
    rw_kernel(const V* __restrict__ vals, const I* __restrict__ cols,
              const int* __restrict__ counts, const int* __restrict__ panel_nnz,
              int rows_per_panel, const float* __restrict__ x, float* __restrict__ y, int m,
              int width, int k) {
  if (kStop) {
    const unsigned t = blockIdx.x * kRwThreads + threadIdx.x;
    if (t >= (unsigned)m * (unsigned)k) return;
    const int r = (int)(t / (unsigned)k);
    const int c = (int)(t - (unsigned)r * (unsigned)k);
    if (panel_nnz != nullptr && panel_nnz[r / rows_per_panel] == 0) {
      y[t] = 0.f;
      return;
    }
    y[t] = slot_dot_peeled(vals + (size_t)r * width, cols + (size_t)r * width, x,
                           rw_stop(counts, r, width), k, c);
  } else {
    const long long t = (long long)blockIdx.x * kRwThreads + threadIdx.x;
    if (t >= (long long)m * k) return;
    const int r = (int)(t / k), c = (int)(t % k);
    y[t] = panel_nnz == nullptr || panel_nnz[r / rows_per_panel] > 0
               ? slot_dot(vals + (size_t)r * width, cols + (size_t)r * width, x, width, k, c)
               : 0.f;
  }
}

// Launch the row-window matvec on `stream` (the stopped kernel when
// counts are given); returns cudaGetLastError() of the launch.
template <typename V, typename I>
int rw_launch(const void* vals, const void* cols, const void* counts, const void* panel_nnz,
              int rows_per_panel, const void* x, void* y, int m, int width, int k,
              cudaStream_t stream) {
  const unsigned grid = (unsigned)(((long long)m * k + kRwThreads - 1) / kRwThreads);
  if (counts != nullptr)
    rw_kernel<V, I, true><<<grid, kRwThreads, 0, stream>>>(
        (const V*)vals, (const I*)cols, (const int*)counts, (const int*)panel_nnz,
        rows_per_panel, (const float*)x, (float*)y, m, width, k);
  else
    rw_kernel<V, I, false><<<grid, kRwThreads, 0, stream>>>(
        (const V*)vals, (const I*)cols, nullptr, (const int*)panel_nnz, rows_per_panel,
        (const float*)x, (float*)y, m, width, k);
  return (int)cudaGetLastError();
}

namespace {

constexpr int kCheckThreads = 256;

// Pick ids are checked on the device, as PyTorch's indexing kernels check
// theirs: a one-pass kernel asserts 0 <= pick < limit, launched just before
// a sweep on the same stream, so a bad id stops there and the sweep queued
// behind it never runs.  The host never reads the picks back.
__global__ void check_picks(const int* __restrict__ picks, int steps, int limit) {
  const int s = blockIdx.x * kCheckThreads + threadIdx.x;
  if (s < steps) {
    const int r = picks[s];
    assert(r >= 0 && r < limit);
  }
}

inline void launch_check(const void* picks, int steps, int limit, cudaStream_t stream) {
  check_picks<<<(steps + kCheckThreads - 1) / kCheckThreads, kCheckThreads, 0, stream>>>(
      (const int*)picks, steps, limit);
}

}  // namespace
