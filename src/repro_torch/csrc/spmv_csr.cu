// y = A x over the sliced-ELL view of a CSR operator, plain and with
// empty-panel predication.
//
// Replaces the TPU kernels src/repro/kernels/spmv_csr.py::spmv_csr_sliced
// and ::spmv_csr_sliced_prefetch.  Inputs: per-row value/column windows
// vals, cols of shape (num_panels * rows_per_panel, width) (padding slots
// carry value 0, column 0), x (n, k) f32; output y (m, k) f32.  The
// prefetch variant also takes panel_nnz (num_panels,) and writes zeros for
// the rows of panels that hold no nonzero.
//
// What bounds it.  About 2 flops per stored byte of the window at k = 1 and
// 2k per window slot overall: far below the card's f32 rate, so the bound
// is bytes (the windows, x once, y once).  The x gathers are random rows of
// x; at the main-path sizes x fits in L2.
//
// Design.  One thread per output element (row r, column c), neighbouring
// threads on neighbouring c, so the gathers x[cols[r,w], c] of a warp
// coalesce along the row of x and the window reads broadcast.  Each thread
// contracts its row window in slot order with fmaf (slot_dot in
// common.cuh, shared with the ELL matvec), so the result does not
// depend on the launch shape.  The predicated variant calls the same device
// function and writes zeros for empty panels, so the two kernels are
// bitwise equal by construction (the TPU pair reduced in different tile
// orders and were not; ROADMAP queue 3 fault b).  The 128-row tile padding
// of the TPU wrapper is not carried over: rows >= m are never launched.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    sliced_kernel(const V* __restrict__ vals, const I* __restrict__ cols,
                  const float* __restrict__ x, float* __restrict__ y, int m, int width, int k) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)m * k) return;
  const int r = (int)(t / k), c = (int)(t % k);
  y[t] = slot_dot(vals + (size_t)r * width, cols + (size_t)r * width, x, width, k, c);
}

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    sliced_prefetch_kernel(const V* __restrict__ vals, const I* __restrict__ cols,
                           const int* __restrict__ panel_nnz, const float* __restrict__ x,
                           float* __restrict__ y, int m, int width, int k, int rows_per_panel) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)m * k) return;
  const int r = (int)(t / k), c = (int)(t % k);
  y[t] = panel_nnz[r / rows_per_panel] > 0
             ? slot_dot(vals + (size_t)r * width, cols + (size_t)r * width, x, width, k, c)
             : 0.f;
}

inline dim3 grid_for(int m, int k) {
  return dim3((unsigned)(((long long)m * k + kThreads - 1) / kThreads));
}

}  // namespace

#define SLICED_ENTRY(NAME, V, I)                                                            \
  extern "C" int NAME(const void* vals, const void* cols, const void* x, void* y, int m,   \
                      int width, int k, void* stream) {                                     \
    sliced_kernel<V, I><<<grid_for(m, k), kThreads, 0, (cudaStream_t)stream>>>(            \
        (const V*)vals, (const I*)cols, (const float*)x, (float*)y, m, width, k);          \
    return (int)cudaGetLastError();                                                         \
  }

#define PREFETCH_ENTRY(NAME, V, I)                                                          \
  extern "C" int NAME(const void* vals, const void* cols, const void* panel_nnz,           \
                      const void* x, void* y, int m, int width, int k, int rows_per_panel,  \
                      void* stream) {                                                       \
    sliced_prefetch_kernel<V, I><<<grid_for(m, k), kThreads, 0, (cudaStream_t)stream>>>(   \
        (const V*)vals, (const I*)cols, (const int*)panel_nnz, (const float*)x, (float*)y, \
        m, width, k, rows_per_panel);                                                       \
    return (int)cudaGetLastError();                                                         \
  }

SLICED_ENTRY(spmv_csr_sliced_f32_i32, float, int32_t)
SLICED_ENTRY(spmv_csr_sliced_bf16_i16, __nv_bfloat16, int16_t)
SLICED_ENTRY(spmv_csr_sliced_bf16_i32, __nv_bfloat16, int32_t)
PREFETCH_ENTRY(spmv_csr_sliced_prefetch_f32_i32, float, int32_t)
PREFETCH_ENTRY(spmv_csr_sliced_prefetch_bf16_i16, __nv_bfloat16, int16_t)
PREFETCH_ENTRY(spmv_csr_sliced_prefetch_bf16_i32, __nv_bfloat16, int32_t)
