// Fused sequential banded block Gauss-Seidel sweep over a halo-padded
// window.
//
// Replaces the TPU kernel src/repro/kernels/banded_gs.py::banded_gs_sweep
// (one grid step per pick, the window resident in VMEM, the picked block
// row's tiles prefetched).  Same arithmetic, per pick bi:
//   g = b[bi] - sum_d A_bands[bi, d] @ xw[bi + d]      (band by band)
//   xw[bi + bands] += beta * g
// Inputs: tiles A_bands (nb, 2*bands+1, block, block) f32 or bf16 with
// border tiles zero-padded (pack_bands_local), b (nb*block, k) f32, the
// window xw ((nb + 2*bands)*block, k) f32, picks (steps,) int32 in [0, nb).
//
// What bounds it.  Each step reads the block rows the previous steps
// wrote, so a column is one chain of `steps` dependent steps.  Per pick
// about 0.35 MB of tiles and b and 2*block*k flops per tile element
// (8.4 MFLOP at block 128, bands 2, k 51): about 0.12 us per pick at the
// card's f32 rate, while each CTA waits on its 20 chunks of staging
// loads from L2 per pick, about 40 us per pick on an H100 (PERF.md).
//
// Design.  The sequential grid of the Pallas kernel becomes a loop over
// picks inside the block.  RHS columns are independent, so the grid is one
// CTA per tile of kt columns, and each CTA steps serially through all the
// picks.  Per pick: band_part (banded.cuh) forms g for the CTA's
// block x kt outputs; __syncthreads(); the threads write xw[(bi+bands)
// block ...]; __syncthreads(), so the next pick's reads see the writes.
// The window stays in global memory: at the main path's size its column
// slice is several hundred KB, more than an SM's 227 KB of shared memory.
// It is never read through the non-coherent cache (no __restrict__ const
// on xw).  The update is rounded as the reference rounds it (beta * g,
// then the add: __fmul_rn/__fadd_rn, no contraction).  Pick ids are
// checked on the device by check_picks (common.cuh) before the sweep.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "banded.cuh"

namespace {

constexpr int kOpt = 2;  // outputs per thread: small column tiles, more CTAs

template <typename V>
__global__ void __launch_bounds__(kBandThreads)
    banded_gs_kernel(const V* __restrict__ A, const float* __restrict__ b, float* xw,
                     const int* __restrict__ picks, int steps, int bands, int block, int k,
                     int kt, float beta) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Xs = smem + block * (kChunk + 1);
  const int c0 = blockIdx.x * kt;
  const int ktile = k - c0 < kt ? k - c0 : kt;
  const int outputs = block * ktile;
  const int width = 2 * bands + 1;
  for (int s = 0; s < steps; ++s) {
    const int bi = picks[s];
    float g[kOpt];
#pragma unroll
    for (int q = 0; q < kOpt; ++q) {
      const int o = threadIdx.x + q * kBandThreads;
      const int r = o / ktile, c = o - r * ktile;
      g[q] = o < outputs ? b[((size_t)bi * block + r) * k + c0 + c] : 0.f;
    }
    for (int d = 0; d < width; ++d) {
      float part[kOpt];
      band_part<V, kOpt>(A + ((size_t)bi * width + d) * block * block,
                         xw + (size_t)(bi + d) * block * k, block, k, c0, ktile, As, Xs, part);
#pragma unroll
      for (int q = 0; q < kOpt; ++q) g[q] = g[q] - part[q];
    }
    __syncthreads();  // every read of this pick's window is done
#pragma unroll
    for (int q = 0; q < kOpt; ++q) {
      const int o = threadIdx.x + q * kBandThreads;
      if (o < outputs) {
        const int r = o / ktile, c = o - r * ktile;
        float* xp = xw + ((size_t)(bi + bands) * block + r) * k + c0 + c;
        *xp = __fadd_rn(*xp, __fmul_rn(beta, g[q]));
      }
    }
    __syncthreads();  // the next pick reads what this one wrote
  }
}

}  // namespace

#define BANDED_GS_ENTRY(NAME, V)                                                               \
  extern "C" int NAME(const void* A, const void* b, void* xw, const void* picks, int steps,   \
                      int limit, int bands, int block, int k, float beta, void* stream) {      \
    launch_check(picks, steps, limit, (cudaStream_t)stream);                                   \
    const int kt = band_tile_cols(block, k, kOpt);                                             \
    banded_gs_kernel<V><<<(unsigned)((k + kt - 1) / kt), kBandThreads,                         \
                          band_smem_bytes(block, kt), (cudaStream_t)stream>>>(                 \
        (const V*)A, (const float*)b, (float*)xw, (const int*)picks, steps, bands, block, k,   \
        kt, beta);                                                                             \
    return (int)cudaGetLastError();                                                            \
  }

BANDED_GS_ENTRY(banded_gs_sweep_f32, float)
BANDED_GS_ENTRY(banded_gs_sweep_bf16, __nv_bfloat16)
