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
// result is bitwise the first port's for every x and does not depend on k.
// The predicated variant, the same kernel with panel_nnz, is bitwise equal
// to the plain one for finite x: on an empty panel the plain one chains
// fmaf(+0, x[0, c], acc) over the padding, so a NaN or inf in x's row 0
// reaches the panel's rows there, where the predicated one writes 0.
// Whole rows a warp (lanes on columns, the window loaded once and
// broadcast from shared memory or registers, up to 16 gathers a lane in
// flight) ran slower on every layout tried: 0.024 ms on both main shapes
// where this mapping takes 0.017 on the LSQ design (PERF.md).  So did x
// staged in shared memory by slices of 8 columns (the TPU kernel keeps x
// whole in VMEM; at n = 4096, k = 51 it does not fit one SM): on the
// empty-panel design 0.026-0.028 ms against 0.019 for this kernel, whose
// products alone took 0.013 and whose copy of the slices 0.007
// (tune/spmv_probe.py --stage-designs keeps that kernel; PERF.md).  The
// 128-row tile padding of the TPU wrapper is not carried over: rows >= m
// are never computed.
//
// The segment-sum pair replaces src/repro/kernels/spmv_csr.py::spmv_csr and
// ::spmv_csr_prefetch, which read the flat layout itself: panel p owns slots
// [p * W, (p + 1) * W) of data/indices/row_id (W = panel_width), and
//   y[r, c] = sum of data[s] * x[indices[s], c] over the panel's slots s
//             with row_id[s] == r, in slot order (fmaf, f32, from +0)
// (the TPU kernels form that sum as a one-hot matmul on the MXU; here it is
// a plain slot loop).  The layout packs a panel's rows from its first slot
// (kernels/spmv_csr.py, core/operators.py::CsrOp): row r's slots are
// [row_start[r], row_start[r] + row_nnz[r]), and the panel's tail after its
// last stored slot holds padding (value +0, column 0, row 0).  So the slots
// of row r inside its panel are exactly its own, except row 0, whose chain
// goes on over panel 0's tail: each tail slot applies g(a) = fmaf(+0,
// x[0, c], a), and g(g(a)) == g(a) (common.cuh, rw_stop's note), so the
// tail applies g once when panel 0 has one (`tail`, computed once per
// operator on the host) and not at all otherwise.  The tails of panels
// p >= 1 hold row 0, outside the panel, and add to no row.
//
// What bounds it: bytes, as above (the stored entries, row_start and
// row_nnz, x once, y once), and above them the x gathers.  Design: the
// row-window mapping (one thread an output, neighbouring threads on
// neighbouring c) with each row's window found through row_start and its
// chain stopped by row_nnz, both loaded together (with panel_nnz in the
// predicated variant) ahead of the chain; slot_dot_peeled then issues the
// first 4 slots' loads together (worth 5-7% on an H100).  On the main SPD
// operator it takes 1.04-1.05x a kernel that only gathers the same rows of
// x, on the empty-panel design 1.09x (tune/spmv_probe.py --gather-floor;
// PERF.md).  No shared memory, no barriers, no
// atomics: a row reads neither row_id, another row's slots nor a tail, and
// no lane idles past its row.  The result is bitwise the row-id sum above
// for every x: each output is the same fmaf chain in the same order
// (tune/spmv_probe.py holds digests of it to compare trees).  It does not
// depend on k, and the predicated variant (the same kernel with panel_nnz,
// zeros written for empty panels as a ternary) is bitwise the plain one
// for finite x (a NaN or inf in row 0 of x reaches row 0 through an empty
// panel 0's tail in the plain one only).  Indices are 32-bit where m * k
// fits (the slots are int32 already: row_start), 64-bit otherwise.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "common.cuh"

namespace {

// Row r's chain from its layout; row 0 adds panel 0's tail term once.
template <typename V, typename I>
__device__ __forceinline__ float segsum_row(const V* __restrict__ data,
                                            const I* __restrict__ indices, int start, int nnz,
                                            const float* __restrict__ x, int k, int r, int c,
                                            int tail) {
  const float acc = slot_dot_peeled(data + start, indices + start, x, nnz, k, c);
  return r == 0 && tail ? fmaf(0.f, x[c], acc) : acc;
}

// Thread t computes output (t / k, t % k) of rows [0, m); `panel_nnz` (or
// nullptr) writes zeros for the rows of empty panels.  k32: m * k < 2^32.
template <typename V, typename I, bool k32>
__global__ void __launch_bounds__(kRwThreads)
    segsum_kernel(const V* __restrict__ data, const I* __restrict__ indices,
                  const int* __restrict__ row_start, const int* __restrict__ row_nnz,
                  const int* __restrict__ panel_nnz, int rows_per_panel,
                  const float* __restrict__ x, float* __restrict__ y, int m, int k, int tail) {
  int r, c;
  size_t t;
  if (k32) {
    const unsigned u = blockIdx.x * kRwThreads + threadIdx.x;
    if (u >= (unsigned)m * (unsigned)k) return;
    r = (int)(u / (unsigned)k);
    c = (int)(u - (unsigned)r * (unsigned)k);
    t = u;
  } else {
    const long long u = (long long)blockIdx.x * kRwThreads + threadIdx.x;
    if (u >= (long long)m * k) return;
    r = (int)(u / k);
    c = (int)(u % k);
    t = (size_t)u;
  }
  const int start = row_start[r], nnz = row_nnz[r];
  y[t] = panel_nnz == nullptr || panel_nnz[r / rows_per_panel] > 0
             ? segsum_row(data, indices, start, nnz, x, k, r, c, tail)
             : 0.f;
}

// Launch the segment sum on `stream`; returns cudaGetLastError().
template <typename V, typename I>
int segsum_launch(const void* data, const void* indices, const void* row_start,
                  const void* row_nnz, const void* panel_nnz, int rows_per_panel, const void* x,
                  void* y, int m, int k, int tail, cudaStream_t stream) {
  const long long outputs = (long long)m * k;
  const unsigned grid = (unsigned)((outputs + kRwThreads - 1) / kRwThreads);
  if (outputs < (1LL << 32))
    segsum_kernel<V, I, true><<<grid, kRwThreads, 0, stream>>>(
        (const V*)data, (const I*)indices, (const int*)row_start, (const int*)row_nnz,
        (const int*)panel_nnz, rows_per_panel, (const float*)x, (float*)y, m, k, tail);
  else
    segsum_kernel<V, I, false><<<grid, kRwThreads, 0, stream>>>(
        (const V*)data, (const I*)indices, (const int*)row_start, (const int*)row_nnz,
        (const int*)panel_nnz, rows_per_panel, (const float*)x, (float*)y, m, k, tail);
  return (int)cudaGetLastError();
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

#define SEGSUM_ENTRY(SFX, V, I)                                                              \
  extern "C" int spmv_csr_##SFX(const void* data, const void* indices, const void* row_start,  \
                                const void* row_nnz, const void* x, void* y, int m, int k,      \
                                int tail, void* stream) {                                       \
    return segsum_launch<V, I>(data, indices, row_start, row_nnz, nullptr, 1, x, y, m, k, tail, \
                               (cudaStream_t)stream);                                          \
  }                                                                                            \
  extern "C" int spmv_csr_prefetch_##SFX(const void* data, const void* indices,                 \
                                         const void* row_start, const void* row_nnz,            \
                                         const void* panel_nnz, const void* x, void* y, int m,  \
                                         int k, int rows_per_panel, int tail, void* stream) {   \
    return segsum_launch<V, I>(data, indices, row_start, row_nnz, panel_nnz, rows_per_panel, x, \
                               y, m, k, tail, (cudaStream_t)stream);                           \
  }

SEGSUM_ENTRY(f32_i32, float, int32_t)
SEGSUM_ENTRY(bf16_i16, __nv_bfloat16, int16_t)
SEGSUM_ENTRY(bf16_i32, __nv_bfloat16, int32_t)
