// Randomized dense block Gauss-Seidel sweep.
//
// Replaces the TPU kernel src/repro/kernels/block_gs.py::block_gs_sweep
// (one grid step per block id, x resident in VMEM, the picked (block, n)
// row panel of A streamed in and fed to the MXU).  Same arithmetic, per
// step s with B = blocks[s]:
//   g = b[B] - A[B, :] @ x          (f32 accumulation)
//   x[B] = x[B] + beta * g          (rounded as written: no contraction)
// Inputs: A (n, n) f32 or bf16 (widened on load), b and x (n, k) f32,
// blocks (steps,) int32 in [0, n / block); x is updated in place.
//
// What bounds it.  Every step reads its whole (block, n) row panel of A:
// at the main path's size (n = 16384, block = 128, k = 51) 8 MiB and
// 2 * block * n * k = 214 MFLOP per step, so the f32 rate (no tensor
// cores: IEEE f32, not TF32) bounds a step at about 3.2 us and the panel
// bytes at about 2.5 us on an H100.  The steps form a serial chain: step
// s + 1 reads the rows step s wrote.
//
// Design.  One cooperative launch runs the whole chain; the grid is sized
// to what can be resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and crosses cooperative_groups grid barriers, two per step:
//  1. partial products.  The n-reduction is split into fixed slices of
//     kSlice columns of A; a work item is (slice, tile of kt columns of
//     x), and CTAs take work items round robin.  A CTA stages the slice's
//     panel columns and x rows through shared memory kChunk columns at a
//     time and each thread sums, for one column of x and kOpt rows of the
//     panel, over the slice's columns in order with fmaf; it writes the
//     partial sums to a scratch array (slices, block, k).
//  2. reduce and update.  Each output (row, column) of the step's block
//     adds its slices' partial sums in slice order, then updates x.
// So every output is summed in a fixed order that depends on n and on
// neither k, kt nor the grid: two runs agree bitwise, and a column of x
// comes out the same whatever other columns ride along.  No atomics.
// x and the partials cross the barriers through global memory and are
// read with __ldcg (at L2, never a stale L1 line).
//
// Each C entry first launches the pick check (common.cuh), then the sweep,
// on the caller's stream, and returns the launch's error code.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kOpt = 8;       // panel rows per thread
constexpr int kChunk = 32;    // panel columns staged per pass
constexpr int kLd = kChunk + 4;  // staged row stride: float4-aligned, rows on distinct banks
constexpr int kSlice = 256;   // panel columns per partial sum: fixes the reduction order

__host__ __device__ inline int row_groups(int block) { return (block + kOpt - 1) / kOpt; }

// Columns of x per work item: every (row group, column) pair is a thread.
inline int tile_cols(int block, int k) {
  int kt = kThreads / row_groups(block);
  kt = kt > 0 ? kt : 1;
  return kt < k ? kt : k;
}

__host__ __device__ inline int slices(int n) { return (n + kSlice - 1) / kSlice; }

inline size_t smem_bytes(int block, int kt) {
  return sizeof(float) * ((size_t)row_groups(block) * kOpt * kLd + (size_t)kChunk * kt);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    block_gs_kernel(const V* __restrict__ A, const float* __restrict__ b, float* x, float* part,
                    const int* __restrict__ blocks, int steps, int n, int block, int k, int kt,
                    float beta) {
  extern __shared__ __align__(16) float smem[];
  const int rows = row_groups(block) * kOpt;  // staged rows: block rounded up to kOpt
  float* As = smem;                           // rows x kLd, row-major
  float* Xs = smem + rows * kLd;              // kChunk x ktile
  cg::grid_group grid = cg::this_grid();
  const int num_slices = slices(n);
  const int tiles = (k + kt - 1) / kt;
  const int items = num_slices * tiles;
  const int outputs = block * k;
  for (int s = 0; s < steps; ++s) {
    const int bi = blocks[s];
    const V* panel = A + (size_t)bi * block * n;
    // 1. partial products of the step's row panel, slice by slice
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int sl = w / tiles;
      const int c0 = (w - sl * tiles) * kt;
      const int ktile = k - c0 < kt ? k - c0 : kt;
      const int rg = threadIdx.x / ktile, c = threadIdx.x - rg * ktile;
      const bool active = rg * kOpt < block;
      const int j_end = n < (sl + 1) * kSlice ? n : (sl + 1) * kSlice;
      float acc[kOpt];
#pragma unroll
      for (int i = 0; i < kOpt; ++i) acc[i] = 0.f;
      for (int j0 = sl * kSlice; j0 < j_end; j0 += kChunk) {
        const int jc = j_end - j0 < kChunk ? j_end - j0 : kChunk;
        __syncthreads();  // the previous chunk's readers are done with As/Xs
        {
          // thread t stages column t % kChunk of every (kThreads / kChunk)-th
          // row; slots past the chunk or the block hold exact zeros
          const int j = threadIdx.x % kChunk;
#pragma unroll 8
          for (int r = threadIdx.x / kChunk; r < rows; r += kThreads / kChunk)
            As[r * kLd + j] = (r < block && j < jc) ? to_f32(panel[(size_t)r * n + j0 + j]) : 0.f;
        }
        for (int e = threadIdx.x; e < kChunk * ktile; e += kThreads) {
          const int j = e / ktile, cc = e - j * ktile;
          Xs[e] = j < jc ? __ldcg(x + (size_t)(j0 + j) * k + c0 + cc) : 0.f;
        }
        __syncthreads();
        if (active) {
          const float* ar = As + rg * kOpt * kLd;
          const int jc4 = (jc + 3) & ~3;  // the zero slots add exact zeros
          for (int j = 0; j < jc4; j += 4) {
            const float x0 = Xs[j * ktile + c], x1 = Xs[(j + 1) * ktile + c];
            const float x2 = Xs[(j + 2) * ktile + c], x3 = Xs[(j + 3) * ktile + c];
#pragma unroll
            for (int i = 0; i < kOpt; ++i) {
              const float4 a = *reinterpret_cast<const float4*>(ar + i * kLd + j);
              acc[i] = fmaf(a.x, x0, acc[i]);
              acc[i] = fmaf(a.y, x1, acc[i]);
              acc[i] = fmaf(a.z, x2, acc[i]);
              acc[i] = fmaf(a.w, x3, acc[i]);
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < kOpt; ++i) {
          const int r = rg * kOpt + i;
          if (r < block) part[((size_t)sl * block + r) * k + c0 + c] = acc[i];
        }
      }
    }
    grid.sync();  // every partial sum of this step is written
    // 2. each output adds its slices in order, then updates its row of x
    for (int o = blockIdx.x * kThreads + threadIdx.x; o < outputs; o += gridDim.x * kThreads) {
      float sum = 0.f;
#pragma unroll 8
      for (int sl = 0; sl < num_slices; ++sl)
        sum = __fadd_rn(sum, __ldcg(part + (size_t)sl * outputs + o));
      const size_t at = (size_t)bi * block * k + o;  // row bi * block + o / k, column o % k
      x[at] = __fadd_rn(__ldcg(x + at), __fmul_rn(beta, __fsub_rn(b[at], sum)));
    }
    grid.sync();  // the next step reads x and rewrites the partials
  }
}

template <typename V>
int launch(const void* A, const void* b, void* x, void* part, const void* blocks, int steps,
           int limit, int n, int block, int k, float beta, cudaStream_t stream) {
  launch_check(blocks, steps, limit, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int kt = tile_cols(block, k);
  const size_t smem = smem_bytes(block, kt);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_gs_kernel<V>, kThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // enough CTAs for the larger phase, no more than can be resident at once
  const int items = slices(n) * ((k + kt - 1) / kt);
  const int updates = (block * k + kThreads - 1) / kThreads;
  int grid = items > updates ? items : updates;
  grid = grid < per_sm * sms ? grid : per_sm * sms;
  const V* a = (const V*)A;
  const float* bp = (const float*)b;
  float* xp = (float*)x;
  float* pp = (float*)part;
  const int* bl = (const int*)blocks;
  void* args[] = {(void*)&a, (void*)&bp, (void*)&xp, (void*)&pp, (void*)&bl, (void*)&steps,
                  (void*)&n, (void*)&block, (void*)&k, (void*)&kt, (void*)&beta};
  err = cudaLaunchCooperativeKernel((const void*)block_gs_kernel<V>, dim3((unsigned)grid),
                                    dim3(kThreads), args, smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Floats of the partial-sum scratch the caller allocates: (slices, block, k).
extern "C" long long block_gs_scratch_floats(int n, int block, int k) {
  return (long long)slices(n) * block * k;
}

#define BLOCK_GS_ENTRY(NAME, V)                                                              \
  extern "C" int NAME(const void* A, const void* b, void* x, void* part, const void* blocks, \
                      int steps, int limit, int n, int block, int k, float beta,             \
                      void* stream) {                                                        \
    return launch<V>(A, b, x, part, blocks, steps, limit, n, block, k, beta,                 \
                     (cudaStream_t)stream);                                                  \
  }

BLOCK_GS_ENTRY(block_gs_sweep_f32, float)
BLOCK_GS_ENTRY(block_gs_sweep_bf16, __nv_bfloat16)
