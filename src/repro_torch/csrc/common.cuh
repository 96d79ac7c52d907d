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

// One output of a row-window matvec: sum_w vals[w] * x[cols[w], c] over a
// row's `width` slots, in slot order with fmaf, so the result does not
// depend on the launch shape or on how many columns x has.  Shared by the
// CSR (sliced-ELL) and ELL matvec kernels.
template <typename V, typename I>
__device__ __forceinline__ float slot_dot(const V* __restrict__ vr, const I* __restrict__ cr,
                                          const float* __restrict__ x, int width, int k, int c) {
  float acc = 0.f;
  for (int w = 0; w < width; ++w) acc = fmaf(to_f32(vr[w]), x[(size_t)(int)cr[w] * k + c], acc);
  return acc;
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
