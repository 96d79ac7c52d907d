// Fused sequential banded sweeps over a halo-padded window: block
// Gauss-Seidel, and masked block Kaczmarz on two carries.
//
// Replaces the TPU kernels src/repro/kernels/banded_gs.py::banded_gs_sweep
// and ::banded_rk_sweep (one grid step per pick, the window resident in
// VMEM, the picked block row's tiles prefetched).  Same arithmetic, per
// pick bi:
//   g = b[bi] - sum_d A_bands[bi, d] @ xw[bi + d]      (band by band)
//   GS:  xw[bi + bands] += beta * g
//   RK:  gn = ((gate ? beta : 0) * g) / rn[bi]          (per row of the panel)
//        xw[bi + d] += A_bands[bi, d]^T @ gn, and the same to dw[bi + d],
//        for every band d (the Cimmino-within-panel action; dw is the
//        round delta the distributed engine all-reduces, never read here)
// Inputs: tiles A_bands (nb, 2*bands+1, block, block) f32 or bf16 with
// border tiles zero-padded (pack_bands_local), b (nb*block, k) f32, the
// windows xw (and dw) ((nb + 2*bands)*block, k) f32, picks (steps,) int32
// in [0, nb); RK also rn (nb, block) f32 squared row norms (zero rows
// guarded to 1 by the caller) and gates (steps,) int32, 0 for a pick the
// caller's rank does not own: it does the same reads and adds exact zeros.
//
// What bounds it.  Each step reads the block rows the previous steps
// wrote, so a column is one chain of `steps` dependent steps.  Per pick
// about 0.35 MB of tiles and b and 2*block*k flops per tile element
// (8.4 MFLOP at block 128, bands 2, k 51; twice that for RK, which also
// forms A^T gn): about 0.12 us per pick at the card's f32 rate (0.25 us for
// RK), while each CTA waits on its 20 chunks of staging loads from L2 per
// pick, about 40 us per GS pick on an H100 (PERF.md).
//
// Design.  The sequential grid of the Pallas kernel becomes a loop over
// picks inside the block.  RHS columns are independent, so the grid is one
// CTA per tile of kt columns, and each CTA steps serially through all the
// picks.  Per pick: band_part (banded.cuh) forms g for the CTA's
// block x kt outputs; __syncthreads(); GS writes xw[(bi+bands) block ...].
// RK writes gn to shared memory, crosses a barrier (the transposed product
// needs all of gn, and every read of the window must be done before a
// write), then each thread forms its outputs of A_d^T gn, a sum over the
// tile's rows in order with fmaf, reading the tile from global memory (it
// was just staged from L2, so the reads hit the caches), and adds it to
// both windows; the 2*bands+1 block rows written are distinct.  A
// closing __syncthreads() lets the next pick read the writes.  The windows
// stay in global memory: at the main path's size a column slice is several
// hundred KB, more than an SM's 227 KB of shared memory.  They are never
// read through the non-coherent cache (no __restrict__ const on xw, dw).
// Updates are rounded as the reference rounds them (beta * g, then / rn,
// then the add: __fmul_rn / __fdiv_rn / __fadd_rn, no contraction), so the
// two RK carries see the same values: from xw = dw = 0 they end bitwise
// equal.  Every output's value depends only on its row and its column, not
// on kt or k.  Pick ids are checked on the device by check_picks
// (common.cuh) before the sweep.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch.
#include "banded.cuh"

namespace {

constexpr int kOpt = 2;  // outputs per thread: small column tiles, more CTAs

// g = b[bi] - sum_d A_bands[bi, d] @ xw[bi + d] for the CTA's outputs
// (zero where o >= outputs).  Every thread of the CTA must call it.
template <typename V>
__device__ __forceinline__ void panel_residual(const V* __restrict__ A, const float* __restrict__ b,
                                               const float* xw, int bi, int bands, int block,
                                               int k, int c0, int ktile, float* As, float* Xs,
                                               float (&g)[kOpt]) {
  const int outputs = block * ktile;
  const int width = 2 * bands + 1;
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
}

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
  for (int s = 0; s < steps; ++s) {
    const int bi = picks[s];
    float g[kOpt];
    panel_residual<V>(A, b, xw, bi, bands, block, k, c0, ktile, As, Xs, g);
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

template <typename V>
__global__ void __launch_bounds__(kBandThreads)
    banded_rk_kernel(const V* __restrict__ A, const float* __restrict__ b,
                     const float* __restrict__ rn, float* xw, float* dw,
                     const int* __restrict__ picks, const int* __restrict__ gates, int steps,
                     int bands, int block, int k, int kt, float beta) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Xs = smem + block * (kChunk + 1);
  float* Gs = Xs + kChunk * kt;  // the pick's gn, block x ktile, row-major
  const int c0 = blockIdx.x * kt;
  const int ktile = k - c0 < kt ? k - c0 : kt;
  const int outputs = block * ktile;
  const int width = 2 * bands + 1;
  for (int s = 0; s < steps; ++s) {
    const int bi = picks[s];
    const float betam = gates[s] > 0 ? beta : 0.f;
    float g[kOpt];
    panel_residual<V>(A, b, xw, bi, bands, block, k, c0, ktile, As, Xs, g);
#pragma unroll
    for (int q = 0; q < kOpt; ++q) {
      const int o = threadIdx.x + q * kBandThreads;
      if (o < outputs)
        Gs[o] = __fdiv_rn(__fmul_rn(betam, g[q]), rn[(size_t)bi * block + o / ktile]);
    }
    __syncthreads();  // gn is complete, and every read of the window is done
    for (int d = 0; d < width; ++d) {
      const V* tile = A + ((size_t)bi * width + d) * block * block;
      float acc[kOpt];
#pragma unroll
      for (int q = 0; q < kOpt; ++q) acc[q] = 0.f;
#pragma unroll 4
      for (int r = 0; r < block; ++r) {
#pragma unroll
        for (int q = 0; q < kOpt; ++q) {
          const int o = threadIdx.x + q * kBandThreads;
          if (o < outputs) {
            const int j = o / ktile, c = o - j * ktile;
            acc[q] = fmaf(to_f32(tile[(size_t)r * block + j]), Gs[r * ktile + c], acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kOpt; ++q) {
        const int o = threadIdx.x + q * kBandThreads;
        if (o < outputs) {
          const int j = o / ktile, c = o - j * ktile;
          const size_t at = ((size_t)(bi + d) * block + j) * k + c0 + c;
          xw[at] = __fadd_rn(xw[at], acc[q]);
          dw[at] = __fadd_rn(dw[at], acc[q]);
        }
      }
    }
    __syncthreads();  // the next pick reads what this one wrote, and rewrites Gs
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

#define BANDED_RK_ENTRY(NAME, V)                                                               \
  extern "C" int NAME(const void* A, const void* b, const void* rn, void* xw, void* dw,        \
                      const void* picks, const void* gates, int steps, int limit, int bands,   \
                      int block, int k, float beta, void* stream) {                            \
    launch_check(picks, steps, limit, (cudaStream_t)stream);                                   \
    const int kt = band_tile_cols(block, k, kOpt);                                             \
    banded_rk_kernel<V><<<(unsigned)((k + kt - 1) / kt), kBandThreads,                         \
                          band_smem_bytes(block, kt) + sizeof(float) * block * kt,             \
                          (cudaStream_t)stream>>>(                                             \
        (const V*)A, (const float*)b, (const float*)rn, (float*)xw, (float*)dw,                \
        (const int*)picks, (const int*)gates, steps, bands, block, k, kt, beta);               \
    return (int)cudaGetLastError();                                                            \
  }

BANDED_GS_ENTRY(banded_gs_sweep_f32, float)
BANDED_GS_ENTRY(banded_gs_sweep_bf16, __nv_bfloat16)
BANDED_RK_ENTRY(banded_rk_sweep_f32, float)
BANDED_RK_ENTRY(banded_rk_sweep_bf16, __nv_bfloat16)
