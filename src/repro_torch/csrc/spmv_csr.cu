// y = A x of a CSR operator: over its sliced-ELL view, plain and with
// empty-panel predication; and over its flat panel-aligned layout by a
// segment sum, plain and with empty-panel predication.
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
// The segment-sum pair replaces src/repro/kernels/spmv_csr.py::spmv_csr and
// ::spmv_csr_prefetch, which read the flat layout itself: panel p owns slots
// [p * W, (p + 1) * W) of data/indices/row_id (W = panel_width), and
//   y[r, c] = sum of data[s] * x[indices[s], c] over the panel's slots s
//             with row_id[s] == r, in slot order (fmaf, f32)
// (the TPU kernels form that sum as a one-hot matmul on the MXU; here it is
// a plain slot loop).  Padding slots carry value 0 and row 0, so they add
// exact zeros to row 0 of panel 0 and nothing elsewhere.  The prefetch
// variant writes zeros for the rows of panels with panel_nnz == 0 without
// reading their slots.  What bounds it: bytes, as above, plus the row ids.
// Design: one CTA per panel stages kSlots slots at a time in shared memory
// (values widened to f32, indices to int, row ids made panel-local) and
// notes each local row's first and last slot (atomicMin/atomicMax: the
// result does not depend on their order); each thread owns up to kSegOpt
// outputs of the panel and scans only its row's slot range, adding the
// slots whose row matches in slot order.  Both kernels call one device
// function, segsum_panel, so they are bitwise equal by construction, and
// a column's result does not depend on k.  They add the same nonzero
// terms in the same order as the sliced kernels (a row's slots are its
// window), so the two matvec families may agree bitwise too.
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

constexpr int kSegThreads = 128;
constexpr int kSegOpt = 4;    // outputs per thread per pass over the slots
constexpr int kSlots = 256;   // slots staged per chunk

inline size_t segsum_smem_bytes(int rows_per_panel) {
  return (size_t)kSlots * (sizeof(float) + 2 * sizeof(int)) + 2 * sizeof(int) * rows_per_panel;
}

// The rows of panel p.  Every thread of the CTA must call it.
template <typename V, typename I>
__device__ __forceinline__ void segsum_panel(const V* __restrict__ data,
                                             const I* __restrict__ indices,
                                             const int* __restrict__ row_id,
                                             const float* __restrict__ x, float* __restrict__ y,
                                             int p, int m, int k, int R, int W) {
  extern __shared__ int seg_smem[];
  float* vs = reinterpret_cast<float*>(seg_smem);  // kSlots values
  int* cs = seg_smem + kSlots;                     // kSlots column ids
  int* ls = cs + kSlots;                           // kSlots panel-local row ids
  int* first = ls + kSlots;                        // R: first staged slot of a row
  int* last = first + R;                           // R: last staged slot of a row
  const int row0 = p * R;
  const int rows = m - row0 < R ? m - row0 : R;
  const int outputs = rows * k;
  const size_t base = (size_t)p * W;
  for (int o0 = 0; o0 < outputs; o0 += kSegThreads * kSegOpt) {
    float acc[kSegOpt];
#pragma unroll
    for (int q = 0; q < kSegOpt; ++q) acc[q] = 0.f;
    for (int s0 = 0; s0 < W; s0 += kSlots) {
      const int sc = W - s0 < kSlots ? W - s0 : kSlots;
      __syncthreads();  // the previous chunk's readers are done
      for (int r = threadIdx.x; r < R; r += kSegThreads) {
        first[r] = kSlots;
        last[r] = -1;
      }
      __syncthreads();
      for (int s = threadIdx.x; s < sc; s += kSegThreads) {
        const size_t at = base + s0 + s;
        const int lr = row_id[at] - row0;
        vs[s] = to_f32(data[at]);
        cs[s] = (int)indices[at];
        ls[s] = lr;
        if (lr >= 0 && lr < rows) {
          atomicMin(first + lr, s);
          atomicMax(last + lr, s);
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kSegOpt; ++q) {
        const int o = o0 + threadIdx.x + q * kSegThreads;
        if (o < outputs) {
          const int r = o / k, c = o - r * k;
          float a = acc[q];
          for (int s = first[r]; s <= last[r]; ++s)
            if (ls[s] == r) a = fmaf(vs[s], x[(size_t)cs[s] * k + c], a);
          acc[q] = a;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSegOpt; ++q) {
      const int o = o0 + threadIdx.x + q * kSegThreads;
      if (o < outputs) y[(size_t)row0 * k + o] = acc[q];
    }
  }
}

template <typename V, typename I>
__global__ void __launch_bounds__(kSegThreads)
    segsum_kernel(const V* __restrict__ data, const I* __restrict__ indices,
                  const int* __restrict__ row_id, const float* __restrict__ x,
                  float* __restrict__ y, int m, int k, int R, int W) {
  segsum_panel<V, I>(data, indices, row_id, x, y, blockIdx.x, m, k, R, W);
}

template <typename V, typename I>
__global__ void __launch_bounds__(kSegThreads)
    segsum_prefetch_kernel(const V* __restrict__ data, const I* __restrict__ indices,
                           const int* __restrict__ row_id, const int* __restrict__ panel_nnz,
                           const float* __restrict__ x, float* __restrict__ y, int m, int k,
                           int R, int W) {
  const int p = blockIdx.x;
  if (panel_nnz[p] > 0) {  // uniform over the CTA
    segsum_panel<V, I>(data, indices, row_id, x, y, p, m, k, R, W);
    return;
  }
  const int row0 = p * R;
  const int outputs = (m - row0 < R ? m - row0 : R) * k;
  for (int o = threadIdx.x; o < outputs; o += kSegThreads) y[(size_t)row0 * k + o] = 0.f;
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

#define SEGSUM_ENTRY(NAME, V, I)                                                             \
  extern "C" int NAME(const void* data, const void* indices, const void* row_id,            \
                      const void* x, void* y, int m, int k, int R, int W, void* stream) {   \
    segsum_kernel<V, I><<<(unsigned)((m + R - 1) / R), kSegThreads, segsum_smem_bytes(R),  \
                          (cudaStream_t)stream>>>((const V*)data, (const I*)indices,        \
                                                  (const int*)row_id, (const float*)x,      \
                                                  (float*)y, m, k, R, W);                   \
    return (int)cudaGetLastError();                                                          \
  }

#define SEGSUM_PREFETCH_ENTRY(NAME, V, I)                                                    \
  extern "C" int NAME(const void* data, const void* indices, const void* row_id,            \
                      const void* panel_nnz, const void* x, void* y, int m, int k, int R,   \
                      int W, void* stream) {                                                 \
    segsum_prefetch_kernel<V, I><<<(unsigned)((m + R - 1) / R), kSegThreads,                \
                                   segsum_smem_bytes(R), (cudaStream_t)stream>>>(           \
        (const V*)data, (const I*)indices, (const int*)row_id, (const int*)panel_nnz,       \
        (const float*)x, (float*)y, m, k, R, W);                                             \
    return (int)cudaGetLastError();                                                          \
  }

SEGSUM_ENTRY(spmv_csr_f32_i32, float, int32_t)
SEGSUM_ENTRY(spmv_csr_bf16_i16, __nv_bfloat16, int16_t)
SEGSUM_ENTRY(spmv_csr_bf16_i32, __nv_bfloat16, int32_t)
SEGSUM_PREFETCH_ENTRY(spmv_csr_prefetch_f32_i32, float, int32_t)
SEGSUM_PREFETCH_ENTRY(spmv_csr_prefetch_bf16_i16, __nv_bfloat16, int16_t)
SEGSUM_PREFETCH_ENTRY(spmv_csr_prefetch_bf16_i32, __nv_bfloat16, int32_t)
