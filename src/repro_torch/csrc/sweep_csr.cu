// Fused sequential sweeps over padded sparse rows: coordinate Gauss-Seidel
// and Kaczmarz, the latter also on two carries.
//
// Replaces the TPU kernels src/repro/kernels/sweep_csr.py::sweep_rows_gs,
// ::sweep_rows_rk and ::sweep_rows_rk_delta (Pallas, one grid step per
// pick, iterate resident in VMEM).  Same arithmetic, per pick r and RHS
// column c:
//   GS:  gamma = b[r,c] - sum_w vals[r,w] * x[cols[r,w], c]
//        x[write_base + r, c] += beta * gamma
//   RK:  g = (b[r,c] - sum_w vals[r,w] * x[cols[r,w], c]) / rn[r]
//        x[cols[r,w], c] += (beta * vals[r,w]) * g    for every real slot w
//   RK delta (the distributed local phase): the RK step reads and writes
//        the replica x, and the same contribution is also added to the
//        round delta d, which the engine all-reduces at round end.
//
// The RK contribution is rounded explicitly, (beta * v) then * g, then the
// add (__fmul_rn / __fadd_rn: no contraction to an FMA), as the reference
// and the plain version round it.  So both carries of the delta sweep see
// bitwise the same contributions in the same order: from x = d = 0 the two
// outputs are bitwise equal.
//
// What bounds it.  Each step reads what the previous step wrote, so a
// column is one chain of `steps` dependent steps.  The bytes a step needs
// (one row window, one b row) are a few hundred; the roofline bound from
// bytes is far below what the chain's latency allows (a dependent gather
// from L2, a 5-level shuffle reduction and a store per step).  The kernel
// is latency-bound, and its time per pick is the number to watch.
//
// Design.  The sequential grid of the Pallas kernel becomes a loop over
// picks inside the block.  RHS columns are independent (each has its own
// gamma), so one warp owns one column and several columns share a block;
// the grid covers k.  At each step the lanes stride over the `width`
// slots, reduce with shuffles, then GS lane 0 writes x[base + r, c] and RK
// lanes scatter their own real slots.  __syncwarp() closes the step so the
// next step's gathers see its writes (a column never spans warps, so no
// block barrier is needed).  The iterate stays in global memory; at the
// main-path sizes it is L2-resident.
//
// Padding slots (value 0, column 0; operators.CsrOp.padded_rows) are a race
// for a parallel RK scatter: several lanes would update x[0, c] at once.
// The RK scatter therefore skips slots whose value is 0, which adds the
// same exact zero the sequential Pallas scatter adds.  Real columns of one
// row are distinct, so the remaining lane writes never collide.
//
// Pick ids are checked on the device (0 <= r < limit) with assert(), as
// PyTorch's indexing kernels check theirs, by a small kernel launched just
// before the sweep on the same stream (check_picks in common.cuh): a bad
// id stops there with a device-side assert, and the sweep queued behind it
// never runs.  The host never reads the picks back.  The check stays out
// of the sweep's loop: an assert inside the dependent chain made the sweeps 11-15%
// slower (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md).
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "common.cuh"

namespace {

constexpr int kColsPerBlock = 4;  // warps (RHS columns) per block

template <typename V, typename I>
__device__ __forceinline__ float window_dot(const V* vr, const I* cr, const float* x, int width,
                                            int k, int c, int lane) {
  float acc = 0.f;
  for (int w = lane; w < width; w += 32)
    acc = fmaf(to_f32(vr[w]), x[(size_t)(int)cr[w] * k + c], acc);
  return warp_sum(acc);
}

// x is read and written by the same warp across steps: it is not declared
// __restrict__ const, so its loads are never routed through the read-only
// (non-coherent) cache.
template <typename V, typename I>
__global__ void __launch_bounds__(32 * kColsPerBlock)
    gs_kernel(const V* __restrict__ vals, const I* __restrict__ cols, const float* __restrict__ b,
              float* x, const int* __restrict__ picks, int width, int k, int steps, int write_base,
              float beta) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  if (c >= k) return;  // warp-uniform
  for (int s = 0; s < steps; ++s) {
    const int r = picks[s];
    const float dot = window_dot(vals + (size_t)r * width, cols + (size_t)r * width, x, width, k,
                                 c, lane);
    if (lane == 0) {
      float* xr = x + (size_t)(write_base + r) * k + c;
      *xr = *xr + beta * (b[(size_t)r * k + c] - dot);
    }
    __syncwarp();
  }
}

// kDelta: also add every contribution to the delta carry d (which no step
// reads).  Without it d is not touched.
template <typename V, typename I, bool kDelta>
__global__ void __launch_bounds__(32 * kColsPerBlock)
    rk_kernel(const V* __restrict__ vals, const I* __restrict__ cols, const float* __restrict__ b,
              const float* __restrict__ rn, float* x, float* d, const int* __restrict__ picks,
              int width, int k, int steps, float beta) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  if (c >= k) return;  // warp-uniform
  for (int s = 0; s < steps; ++s) {
    const int r = picks[s];
    const V* vr = vals + (size_t)r * width;
    const I* cr = cols + (size_t)r * width;
    const float dot = window_dot(vr, cr, x, width, k, c, lane);
    const float g = (b[(size_t)r * k + c] - dot) / rn[r];
    for (int w = lane; w < width; w += 32) {
      const float v = to_f32(vr[w]);
      if (v != 0.f) {
        const size_t j = (size_t)(int)cr[w] * k + c;
        const float contrib = __fmul_rn(__fmul_rn(beta, v), g);
        x[j] = __fadd_rn(x[j], contrib);
        if constexpr (kDelta) d[j] = __fadd_rn(d[j], contrib);
      }
    }
    __syncwarp();
  }
}

inline dim3 grid_for(int k) { return dim3((k + kColsPerBlock - 1) / kColsPerBlock); }

}  // namespace

#define GS_ENTRY(NAME, V, I)                                                                     \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, void* x,               \
                      const void* picks, int width, int k, int steps, int limit, int write_base, \
                      float beta, void* stream) {                                                \
    launch_check(picks, steps, limit, (cudaStream_t)stream);                                     \
    gs_kernel<V, I><<<grid_for(k), 32 * kColsPerBlock, 0, (cudaStream_t)stream>>>(              \
        (const V*)vals, (const I*)cols, (const float*)b, (float*)x, (const int*)picks, width, k, \
        steps, write_base, beta);                                                                \
    return (int)cudaGetLastError();                                                              \
  }

#define RK_ENTRY(NAME, V, I)                                                                     \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, const void* rn, void* x, \
                      const void* picks, int width, int k, int steps, int limit, float beta,    \
                      void* stream) {                                                            \
    launch_check(picks, steps, limit, (cudaStream_t)stream);                                     \
    rk_kernel<V, I, false><<<grid_for(k), 32 * kColsPerBlock, 0, (cudaStream_t)stream>>>(       \
        (const V*)vals, (const I*)cols, (const float*)b, (const float*)rn, (float*)x, nullptr,  \
        (const int*)picks, width, k, steps, beta);                                               \
    return (int)cudaGetLastError();                                                              \
  }

#define RK_DELTA_ENTRY(NAME, V, I)                                                               \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, const void* rn, void* x, \
                      void* d, const void* picks, int width, int k, int steps, int limit,       \
                      float beta, void* stream) {                                                \
    launch_check(picks, steps, limit, (cudaStream_t)stream);                                     \
    rk_kernel<V, I, true><<<grid_for(k), 32 * kColsPerBlock, 0, (cudaStream_t)stream>>>(        \
        (const V*)vals, (const I*)cols, (const float*)b, (const float*)rn, (float*)x, (float*)d, \
        (const int*)picks, width, k, steps, beta);                                               \
    return (int)cudaGetLastError();                                                              \
  }

GS_ENTRY(sweep_rows_gs_f32_i32, float, int32_t)
GS_ENTRY(sweep_rows_gs_bf16_i16, __nv_bfloat16, int16_t)
GS_ENTRY(sweep_rows_gs_bf16_i32, __nv_bfloat16, int32_t)
RK_ENTRY(sweep_rows_rk_f32_i32, float, int32_t)
RK_ENTRY(sweep_rows_rk_bf16_i16, __nv_bfloat16, int16_t)
RK_ENTRY(sweep_rows_rk_bf16_i32, __nv_bfloat16, int32_t)
RK_DELTA_ENTRY(sweep_rows_rk_delta_f32_i32, float, int32_t)
RK_DELTA_ENTRY(sweep_rows_rk_delta_bf16_i16, __nv_bfloat16, int16_t)
RK_DELTA_ENTRY(sweep_rows_rk_delta_bf16_i32, __nv_bfloat16, int32_t)
