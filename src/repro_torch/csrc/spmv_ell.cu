// y = A x over fixed-width ELL storage.
//
// Replaces the TPU kernel src/repro/kernels/spmv_ell.py::spmv_ell.  Inputs:
// per-row value/column windows vals, cols of shape (rows, width) (padding
// slots carry value 0 and the row's own index), x (n_cols, k) f32; output
// y (rows, k) f32.  The TPU kernel accumulates slot by slot in f32
// (acc += vals[:, j] * x[cols[:, j]]); this one does the same per output.
//
// What bounds it.  2k flops per stored entry against 8 bytes of window
// (f32 values, int32 ids): the HBM bound is bytes (the stored entries,
// the per-row counts, x once, y once).  Above it sit the x gathers, one
// row of x (4k bytes) from L2 per slot chained, as for the sliced CSR
// matvec (csrc/spmv_csr.cu's note); tune/spmv_probe.py times a
// gather-only copy of the kernel and a kernel that only gathers.
//
// Design.  The row-window kernel of the sliced CSR view (rw_kernel in
// common.cuh): one thread an output, and, given the operator's per-row
// counts (EllOp.stop_counts: min(count, width), passed where a quarter
// of the slots or more are padding, 35% at the main shape), each row's
// chain stopped after its first padding slot (value +0, the row's own
// column), with 32-bit indices; otherwise every slot, as the first port.
// Each output stays one fmaf chain over its slots in slot order from +0,
// so the result is bitwise the first port's for every x and a column's
// result does not depend on k.  Any row count and any n_cols (a slab of
// rows of a wider operator, the distributed residual): the TPU wrapper's
// n % 128 tiling fallback has no counterpart here.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "common.cuh"

#define ELL_ENTRY(SFX, V, I)                                                                 \
  extern "C" int spmv_ell_##SFX(const void* vals, const void* cols, const void* counts,       \
                                const void* x, void* y, int n, int width, int k, void* stream) { \
    return rw_launch<V, I>(vals, cols, counts, nullptr, 1, x, y, n, width, k,                  \
                           (cudaStream_t)stream);                                             \
  }

ELL_ENTRY(f32_i32, float, int32_t)
ELL_ENTRY(bf16_i16, __nv_bfloat16, int16_t)
ELL_ENTRY(bf16_i32, __nv_bfloat16, int32_t)
