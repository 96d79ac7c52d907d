// y = A x over fixed-width ELL storage.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py::spmv_ell.  Inputs:
// per-row value/column windows vals, cols of shape (n, width) (padding
// slots carry value 0 and the row's own index), x (n, k) f32; output y
// (n, k) f32.  The TPU kernel accumulates slot by slot in f32
// (acc += vals[:, j] * x[cols[:, j]]); this one does the same per output.
//
// What bounds it.  2k flops per stored slot against 8 bytes of window
// (f32 values, int32 ids): the bound is bytes (the windows, x once, y
// once).  The x gathers are random rows of x, L2-resident at the main
// path's sizes.
//
// Design.  One thread per output element (row r, column c), neighbouring
// threads on neighbouring c, so a warp's gathers coalesce along a row of x
// and its window reads broadcast.  Each thread contracts its window in
// slot order with slot_dot (common.cuh), the device function the sliced
// CSR kernels use, so a column's result does not depend on the launch
// shape or on how many columns ride along.  Any n: the TPU wrapper's
// n % 128 tiling fallback has no counterpart here.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    ell_kernel(const V* __restrict__ vals, const I* __restrict__ cols,
               const float* __restrict__ x, float* __restrict__ y, int n, int width, int k) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * k) return;
  const int r = (int)(t / k), c = (int)(t % k);
  y[t] = slot_dot(vals + (size_t)r * width, cols + (size_t)r * width, x, width, k, c);
}

}  // namespace

#define ELL_ENTRY(NAME, V, I)                                                                \
  extern "C" int NAME(const void* vals, const void* cols, const void* x, void* y, int n,    \
                      int width, int k, void* stream) {                                      \
    const unsigned grid = (unsigned)(((long long)n * k + kThreads - 1) / kThreads);          \
    ell_kernel<V, I><<<grid, kThreads, 0, (cudaStream_t)stream>>>(                           \
        (const V*)vals, (const I*)cols, (const float*)x, (float*)y, n, width, k);           \
    return (int)cudaGetLastError();                                                          \
  }

ELL_ENTRY(spmv_ell_f32_i32, float, int32_t)
ELL_ENTRY(spmv_ell_bf16_i16, __nv_bfloat16, int16_t)
ELL_ENTRY(spmv_ell_bf16_i32, __nv_bfloat16, int32_t)
