// Block-banded matvec: y_i = sum_d A_bands[i, d] @ x[block i + d - bands].
//
// Replaces the TPU kernel src/repro/kernels/bbmv.py::bbmv (one grid step
// per block row, the 2*bands+1 tiles fed to the MXU, out-of-range block
// columns masked to zero).  Inputs: tiles A_bands (nb, 2*bands+1, block,
// block) f32 or bf16, x (nb*block, k) f32; output y (nb*block, k) f32.
//
// What bounds it.  At the main path's shapes (nb = 128, block = 128,
// bands = 2, k = 51) the 634 tiles inside the matrix are 41.5 MB of f32
// and 1.06 GFLOP: about 12 us of HBM and 16 us of the f32 rate on an H100
// (no tensor cores: the port's precision contract keeps IEEE f32, not
// TF32).  On CUDA cores a thread's FMAs take their operands from shared
// memory, which delivers 128 bytes a cycle to an SM while its FP32 units
// take four warp-FMAs a cycle: a thread that owns TM x TN outputs reads
// TM + TN words per tile column for TM * TN FMAs, so shared memory keeps
// up only from 8 x 8 on.  The first version (one output row at a time,
// two shared loads per FMA) ran at about 1/8 of the FMA rate (0.19 ms,
// PERF.md).
//
// Design.  A register-tiled product.  Each thread owns an 8 x 8 micro-tile
// of y: rows wr*64 + rg + 8q (q < 8) and columns wc*32 + 16h + cg*4 + p
// (h < 2, p < 4), with rg = lane % 8, cg = lane / 8.  A warp covers 64
// rows x 32 columns; a CTA of WR x WC warps covers all `block` rows
// (WR = ceil(block / 64)) and a column tile of KT = 32 * WC columns.  The
// tile is staged kChunk tile columns j at a time, row-major with the row
// pitch padded by 16 bytes, so the 8 rows a warp reads at one j lie on
// distinct banks (lanes of one rg broadcast); per j a thread reads its 8
// rows and its 8 x columns (16 words) and does 64 FMAs, the 8 x 8 balance
// above.  The fragments of j + 1 are read while the FMAs of j issue.  At
// the main shape that is 128 CTAs of 4 warps, one per SM: the problem has
// 128 x 64 outputs per block row, so a larger micro-tile would leave
// schedulers idle and a smaller one would be bound by shared memory.
// A broadcast load still delivers its full width to every lane, so the 16
// words per 64 FMAs cost 16 warp-wide shared loads however the lanes
// share addresses; and the tile stays row-major, as cp.async moves 16
// bytes of one tile row (contiguous in j), where a transposed [j][r] copy
// would take one 4-byte copy per element.
//
// Staging.  Stages are double-buffered with one block barrier each: after
// the barrier that publishes stage t (and ends every read of stage t-1),
// the copy of stage t+1 into the other buffer is issued, then stage t is
// multiplied.  Tile rows go by 16-byte cp.async.cg when they are 16-byte
// aligned (block % 4 == 0 for f32, % 8 for bf16; bf16 is widened when a
// fragment is read); ragged or unaligned tiles are loaded and stored
// element by element.  When one column tile holds all k columns, the x
// rows a chunk needs are one contiguous run of kChunk * k floats, copied
// by 16-byte cp.async with row pitch k (4-byte copies of x, one per
// element, took as long as the whole tile); otherwise x goes by 4-byte
// cp.async with row pitch KT.  Tile columns past `block` are zero-filled
// in both operands (cp.async with a short source size), so they add
// fmaf(0, 0, s) = s; rows past `block` and columns past k reach only
// outputs that are never stored.
//
// Summation order: each output y[r, c] is one fmaf chain in one thread,
// from 0, over the bands d in order (those whose block column lies inside
// the matrix; the others are skipped, never read), then over the tile
// columns j = 0, 1, ... in order.  It depends on the output's row and
// column only, not on k, the column tile, the staging mode or the launch
// shape, so a column's result does not depend on how many columns ride
// along.
//
// Grid.  (column tiles, block rows): CTAs that share a block row's tiles
// are adjacent in launch order, so with more than one column tile the
// second read of a tile hits L2.  WC is the smallest of 1, 2, 4 with
// 32 * WC >= k, at most 8 / WR warps a CTA: at the main shape one CTA per
// block row holds all 51 columns (KT = 64); two column tiles of 32 (256
// CTAs) were 20% slower (PERF.md).  chip_smoke.py holds WC = 1 bitwise
// against the rule's result; the C entries take `col_warps` (0 = the rule)
// for that.
//
// Each C entry launches on the caller's stream and returns the error of
// cudaFuncSetAttribute (the stage buffers exceed the 48 KB a launch gets
// without opting in) or cudaGetLastError() of the launch.
#include "common.cuh"

namespace {

constexpr int kChunk = 64;     // tile columns j per stage
constexpr int kWarpRows = 64;  // rows rg + 8q, q < 8, of each of 8 row groups
constexpr int kNX = 2;         // groups of 4 x columns a thread owns
constexpr int kWarpCols = 16 * kNX;  // columns 16h + cg*4 + p (h < kNX) of 4 column groups
constexpr int kMaxWarps = 8;   // at most 256 threads a CTA
// Stage buffers in the ring: one in flight while one is read (three fit in
// shared memory only up to block 192).
constexpr int kStages = 2;
constexpr int kPairUnroll = 4; // trips of two tile columns unrolled

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with a source size of 0 or the full copy: 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 16-byte cp.async reading `bytes` (0..16) and zero-filling the rest.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row pitch of a staged tile chunk, in elements of V: kChunk plus 16
// bytes, so rows stay 16-byte aligned and the 8 rows rg + 8q that a warp
// reads at one j start on distinct banks.
template <typename V>
__host__ __device__ constexpr int pitch() {
  return kChunk + 16 / (int)sizeof(V);
}

// kAsync: the tile chunk goes by 16-byte cp.async (its rows are 16-byte
// aligned); otherwise each thread loads and stores elements.  kXRun: x goes
// as contiguous runs (row pitch k); otherwise by element (row pitch KT).
// WC: column warps, a compile-time count.
template <typename V, int WC, bool kAsync, bool kXRun>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bbmv_kernel(const V* __restrict__ A, const float* __restrict__ x, float* __restrict__ y, int nb,
                int bands, int block, int k) {
  constexpr int KT = kWarpCols * WC;
  constexpr int P = pitch<V>();
  constexpr int kPieces = kChunk * (int)sizeof(V) / 16;  // 16-byte pieces a chunk row
  constexpr int kPiecesPerThread = kWarpRows * kPieces / (32 * WC);
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int rows = kWarpRows * (nthreads / (32 * WC));  // block rounded up to whole warps
  const int tile_bytes = rows * P * (int)sizeof(V);
  const int stage_bytes = tile_bytes + (kChunk + 1) * KT * (int)sizeof(float);
  const int xpitch = kXRun ? k : KT;  // floats from one staged x row to the next
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wc = warp % WC, wr = warp / WC;
  const int rg = lane & 7, cg = lane >> 3;

  const int c0 = blockIdx.x * KT;
  const int i = blockIdx.y;
  const int width = 2 * bands + 1;
  const int dlo = bands - i > 0 ? bands - i : 0;
  const int dhi = nb - 1 - i + bands < width - 1 ? nb - 1 - i + bands : width - 1;
  const int nchunks = (block + kChunk - 1) / kChunk;
  const int stages = (dhi - dlo + 1) * nchunks;  // >= nchunks: band d = bands is inside

  // Stage t: band dlo + t / nchunks, tile columns from (t % nchunks) * kChunk.
  auto stage = [&](int t, unsigned char* buf) {
    const int d = dlo + t / nchunks;
    const int j0 = (t % nchunks) * kChunk;
    const V* tile = A + ((size_t)i * width + d) * block * block;
    V* as = reinterpret_cast<V*>(buf);
    if constexpr (kAsync) {
#pragma unroll
      for (int s = 0; s < kPiecesPerThread; ++s) {
        const int e = tid + s * nthreads;
        const int r = e / kPieces, j = (e % kPieces) * (16 / (int)sizeof(V));
        const bool ok = r < block && j0 + j < block;
        cp_async16(as + r * P + j, ok ? tile + (size_t)r * block + j0 + j : tile, ok);
      }
    } else {
#pragma unroll 8
      for (int e = tid; e < rows * kChunk; e += nthreads) {
        const int r = e / kChunk, j = e % kChunk;
        as[r * P + j] = r < block && j0 + j < block ? tile[(size_t)r * block + j0 + j] : V(0.f);
      }
    }
    const float* xblk = x + (size_t)(i + d - bands) * block * k;
    float* xs = reinterpret_cast<float*>(buf + tile_bytes);
    if constexpr (kXRun) {
      // Rows j0 .. j0 + kChunk of the x block are one run of kChunk * k
      // floats: copied in 16-byte pieces, the part past row `block` zeroed.
      const float* src = xblk + (size_t)j0 * k;
      const int valid = (block - j0 < kChunk ? block - j0 : kChunk) * k;
      for (int e = tid; e < kChunk * k / 4; e += nthreads) {
        const int left = valid - 4 * e;
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
        cp_async16_n(xs + 4 * e, bytes > 0 ? src + 4 * e : src, bytes);
      }
    } else {
      for (int e = tid; e < kChunk * KT; e += nthreads) {
        const int j = e / KT, c = e % KT;
        const bool ok = j0 + j < block && c0 + c < k;
        cp_async4(xs + e, ok ? xblk + (size_t)(j0 + j) * k + c0 + c : xblk, ok);
      }
    }
    cp_async_commit();
  };

  float acc[8][4 * kNX];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int p = 0; p < 4 * kNX; ++p) acc[q][p] = 0.f;

  // Fragments of tile column j: the thread's 8 tile rows and 8 x columns.
  auto fragment = [&](const V* as, const float* xs, int j, float (&a)[8], float (&xv)[4 * kNX]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) a[q] = to_f32(as[8 * q * P + j]);
#pragma unroll
    for (int h = 0; h < kNX; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p) xv[4 * h + p] = xs[j * xpitch + 16 * h + p];
  };

  // acc += a (8 rows) x xv (8 columns), one fmaf each.
  auto outer = [&](const float (&a)[8], const float (&xv)[4 * kNX]) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int p = 0; p < 4 * kNX; ++p) acc[q][p] = fmaf(a[q], xv[p], acc[q][p]);
  };

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < stages) {
      stage(t, smem + t * stage_bytes);
    } else {
      cp_async_commit();  // an empty group keeps the count of pending groups
    }
  }
  for (int t = 0; t < stages; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t is in; every read of stage t-1 is done
    const int ahead = t + kStages - 1;
    if (ahead < stages) {
      stage(ahead, smem + (ahead % kStages) * stage_bytes);
    } else {
      cp_async_commit();
    }
    const unsigned char* cur = smem + (t % kStages) * stage_bytes;
    const V* as = reinterpret_cast<const V*>(cur) + (wr * kWarpRows + rg) * P;
    const float* xs = reinterpret_cast<const float*>(cur + tile_bytes) + wc * kWarpCols + cg * 4;
    // The fragments of j + 1 are read while j's 64 FMAs issue.  Two
    // columns j a trip keep the fragment registers' indices constant; the
    // trips are not all unrolled, which would outgrow the instruction cache.
    float a0[8], a1[8];
    float x0[4 * kNX], x1[4 * kNX];
    fragment(as, xs, 0, a0, x0);
#pragma unroll kPairUnroll
    for (int j = 0; j < kChunk; j += 2) {
      fragment(as, xs, j + 1, a1, x1);
      outer(a0, x0);
      if (j + 2 < kChunk) fragment(as, xs, j + 2, a0, x0);
      outer(a1, x1);
    }
  }

#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = wr * kWarpRows + rg + 8 * q;
    if (r >= block) continue;
    float* yr = y + ((size_t)i * block + r) * k + c0 + wc * kWarpCols + cg * 4;
    const int left = k - (c0 + wc * kWarpCols + cg * 4);  // columns of yr inside y
#pragma unroll
    for (int h = 0; h < kNX; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (16 * h + p < left) yr[16 * h + p] = acc[q][4 * h + p];
  }
}

template <typename V, int WC, bool kAsync, bool kXRun>
cudaError_t launch(const V* A, const float* x, float* y, int nb, int bands, int block, int k,
                   cudaStream_t stream) {
  constexpr int KT = kWarpCols * WC;
  const int wr = (block + kWarpRows - 1) / kWarpRows;
  const size_t smem = kStages * ((size_t)wr * kWarpRows * pitch<V>() * sizeof(V) +
                                 (size_t)(kChunk + 1) * KT * sizeof(float));
  const auto kernel = bbmv_kernel<V, WC, kAsync, kXRun>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((k + KT - 1) / KT), (unsigned)nb);
  kernel<<<grid, 32 * wr * WC, smem, stream>>>(A, x, y, nb, bands, block, k);
  return cudaGetLastError();
}

// The staging modes: the tile by 16-byte copies when its rows are 16-byte
// aligned; x as one run per chunk when one column tile holds all k columns
// and the runs are 16-byte aligned.
template <typename V, int WC>
cudaError_t launch_wc(const V* A, const float* x, float* y, int nb, int bands, int block, int k,
                      cudaStream_t stream) {
  const bool tile16 =
      block % (16 / (int)sizeof(V)) == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool xrun = k <= kWarpCols * WC && (size_t)block * k % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tile16) {
    return xrun ? launch<V, WC, true, true>(A, x, y, nb, bands, block, k, stream)
                : launch<V, WC, true, false>(A, x, y, nb, bands, block, k, stream);
  }
  return xrun ? launch<V, WC, false, true>(A, x, y, nb, bands, block, k, stream)
              : launch<V, WC, false, false>(A, x, y, nb, bands, block, k, stream);
}

// The wrappers (kernels/ops.py) pass 1 <= block <= 256, so 1 <= WR <= 4.
template <typename V>
int bbmv(const void* A, const void* x, void* y, int nb, int bands, int block, int k,
         int col_warps, void* stream) {
  const int wr = (block + kWarpRows - 1) / kWarpRows;
  const int most = kMaxWarps / wr >= 4 ? 4 : kMaxWarps / wr >= 2 ? 2 : 1;
  int wc = col_warps;
  if (wc == 0) {
    wc = 1;
    while (wc < most && kWarpCols * wc < k) wc *= 2;
  }
  if (wc > most) return (int)cudaErrorInvalidValue;
  const V* a = (const V*)A;
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (wc) {
    case 1: return (int)launch_wc<V, 1>(a, xf, yf, nb, bands, block, k, s);
    case 2: return (int)launch_wc<V, 2>(a, xf, yf, nb, bands, block, k, s);
    case 4: return (int)launch_wc<V, 4>(a, xf, yf, nb, bands, block, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bbmv_f32(const void* A, const void* x, void* y, int nb, int bands, int block, int k,
                        int col_warps, void* stream) {
  return bbmv<float>(A, x, y, nb, bands, block, k, col_warps, stream);
}

extern "C" int bbmv_bf16(const void* A, const void* x, void* y, int nb, int bands, int block,
                         int k, int col_warps, void* stream) {
  return bbmv<__nv_bfloat16>(A, x, y, nb, bands, block, k, col_warps, stream);
}
