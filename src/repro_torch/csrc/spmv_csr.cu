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
// What bounds it.  2k flops per stored nonzero against 8 bytes of window
// (f32 values, int32 ids): far below the card's f32 rate, so the HBM bound
// is bytes (the nonzeros, x once, y once).  Above that floor sit the x
// gathers: every stored nonzero reads a whole row of x (4k bytes, 204 at
// k = 51, in 7 or 8 sectors of 32 bytes) from L2, about 10x the HBM bytes
// at the main path's sizes, with few L1 hits when x is much larger than
// L1 (the columns are random).  tune/spmv_probe.py times a gather-only
// copy of this kernel and, apart from this layout, a kernel that only
// gathers the same rows of x (one warp a row): on the main SPD view this
// kernel takes 1.01x the first and 1.06x the second, so the gathers may
// set its time; that L2's rate is what limits them is a hypothesis the
// card's counters would have to confirm (PERF.md).
//
// Design (rw_kernel in common.cuh, shared with the ELL matvec).  One
// thread an output (row r, column c), neighbouring threads on
// neighbouring c, so a warp's gathers read contiguous runs of a row of x
// and its window reads broadcast (L1 hits after the first of the row's
// warps).  Given the operator's count of each row's stored nonzeros
// (`counts`), a row's chain stops after its first padding slot (rw_stop's
// note: the bits are those of every slot chained), the first 4 slots'
// loads go out ahead of the count's, and indices are 32-bit: 41% of the
// main SPD view's slots are padding, each a gather and an fmaf.  Without
// counts the kernel chains every slot with the first port's loop.  The
// operators pass counts only where at least a quarter of their slots are
// padding and rows x k stays below 2^32 (kernels/spmv_csr.py::
// worth_stopping): on a layout without
// padding the count's load ahead of each chain cost 14%.  Each output
// stays one fmaf chain over its row's slots in slot order from +0, so the
// result is bitwise the first port's for every x, does not depend on k,
// and the predicated variant, the same kernel with panel_nnz, is bitwise
// equal to the plain one.  Whole rows a warp (lanes on columns, the
// window loaded once and broadcast from shared memory or registers, up to
// 16 gathers a lane in flight) ran slower on every layout tried: 0.024
// ms on both main shapes where this mapping takes 0.017 on the LSQ design
// (PERF.md).  The 128-row tile padding of the TPU wrapper is not
// carried over: rows >= m are never computed.
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

}  // namespace

#define SLICED_ENTRY(SFX, V, I)                                                            \
  extern "C" int spmv_csr_sliced_##SFX(const void* vals, const void* cols, const void* counts, \
                                       const void* x, void* y, int m, int width, int k,      \
                                       void* stream) {                                       \
    return rw_launch<V, I>(vals, cols, counts, nullptr, 1, x, y, m, width, k,                \
                           (cudaStream_t)stream);                                           \
  }                                                                                         \
  extern "C" int spmv_csr_sliced_prefetch_##SFX(                                             \
      const void* vals, const void* cols, const void* counts, const void* panel_nnz,         \
      const void* x, void* y, int m, int width, int k, int rows_per_panel, void* stream) {   \
    return rw_launch<V, I>(vals, cols, counts, panel_nnz, rows_per_panel, x, y, m, width, k, \
                           (cudaStream_t)stream);                                           \
  }

SLICED_ENTRY(f32_i32, float, int32_t)
SLICED_ENTRY(bf16_i16, __nv_bfloat16, int16_t)
SLICED_ENTRY(bf16_i32, __nv_bfloat16, int32_t)

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
