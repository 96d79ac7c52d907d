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
// Order of operations (what every version of this kernel keeps, so the
// results are bitwise those of the first port): for each row r and column
// c, g starts from b[r, c]; for d = 0 ... 2*bands, part = one fmaf chain
// from 0 over the tile columns j = 0 ... block-1 in order, then g = g -
// part; GS adds __fadd_rn(x, __fmul_rn(beta, g)).  RK forms gn =
// __fdiv_rn(__fmul_rn(betam, g), rn), then contrib[j, c] = one fmaf chain
// from 0 over the tile rows r = 0 ... block-1 in order, added with
// __fadd_rn to xw and to dw.  A value depends on its row and column only:
// not on k, the path or the launch shape, so column 0 at
// k = 51 is column 0 at k = 1, and from xw = dw = 0 the two RK carries end
// bitwise equal.
//
// What bounds it.  Each pick reads the block rows earlier picks wrote, so
// a column is one chain of `steps` dependent picks.  A pick needs its
// 2*bands+1 tiles (320 KB in f32 at block 128, bands 2; 160 KB in bf16)
// and 2 * block^2 * k flops a tile (4 for RK): at k = 51 about 0.12 us a
// pick at the card's f32 rate, 0.25 us for RK.  Every RHS column needs all
// of a pick's tiles, so each CTA streams them into its shared memory and
// reads them once.  On an H100 80GB HBM3 at 700 W (PERF.md) a GS pick
// takes 7.7 us, an RK pick 12.8, and a version without the products took
// as long as with them: the tile stream sets the time, by the count of
// bulk copies more than by their bytes (bf16 tiles, half the bytes, are
// 15% faster), and not because CTAs read the same lines at once.  The
// first port (32 tile columns a stage, two block barriers and an L2 round
// trip each, 13 CTAs of 4 columns) took 40 us a GS pick and 80 an RK pick.
//
// Design.  One RHS column a CTA (51 CTAs at k = 51); warps are specialised:
//  - The window.  Shared-memory path: the CTA's column of xw, all
//    (nb + 2*bands) * block rows, lives in shared memory for the whole
//    launch (67.6 KB at the main shape, 18 KB for a P = 4 rank) and is
//    written back at the end.  Global path (a taller window, chosen by the
//    launcher's size rule, kernels/banded_gs.py::fits_shared): at each pick
//    the consumers copy the pick's 2*bands+1 blocks of the column into
//    shared memory and write the updated block back to global memory; the
//    products run the same code.  dw is only added to, so it stays in
//    global memory; its values are loaded when a pick starts.
//  - The tile stream.  One producer warp walks the pick ids (they are known
//    at launch, and the tiles never depend on x) and copies stages of R
//    (<= 32) rows of one tile into a ring of shared-memory stages, in the
//    order (pick, row group, band).  A tile is row-major, so a stage is 4
//    slices of R / 4 consecutive rows, each one 1-D bulk copy
//    (cp.async.bulk, completion counted in bytes on the stage's full
//    mbarrier), the slices 16 bytes apart beyond their rows: the 8 lanes of
//    a quarter warp take rows of 4 slices, two lanes a bank group.  The
//    ring crosses picks: pick s+1's tiles arrive while pick s updates x.
//    Rows whose bytes are not a multiple of 16 (block 18 in f32, 20 in
//    bf16), or tiles not 16-byte aligned, are staged element by element by
//    the same warp, which then arrives on the full barrier.  Why four:
//    in versions measured side by side (PERF.md), with no products a GS
//    chunk took 0.98 ms at one copy a stage, 1.06 at four, 1.33 at eight
//    (conflict-free), and with them 1.07 at four against 1.35 at eight
//    and 1.26 at two (4-way conflicts); one copy a stage needs its lanes
//    skewed to dodge the banks, which made the products slower (1.53);
//    32 copies a stage, one a row, took 2.90.
//  - No clusters.  The CTAs of neighbouring columns read the same stream,
//    and clusters of 2 or 4 CTAs sharing one stream (each CTA multicasting
//    its share of the slices, a stage freed by remote arrives of every
//    CTA's consumer) were slower at every measured shape: the lockstep cost
//    more than the shared L2 reads saved (PERF.md).
//  - Consumers.  Warp d owns band d, for d < 2*bands+1 up to 15 warps;
//    past 7 bands warp w owns bands w, w + 15, ...  For each row group
//    and band: it waits on the band's stage's full barrier; each lane
//    forms part_d of one row (the fmaf chain over j, a 16-byte tile load
//    feeding 4 or 8 FMAs, x read as a broadcast); the parts meet in
//    shared memory, and after one named barrier warp 0 forms g = b -
//    part_0 - ... (RK: gn), with b (and rn) loaded a row group ahead.  GS
//    frees each stage at once.  RK crosses a second barrier and runs A^T
//    gn on the same staged rows: lane l owns 4 tile columns (two chunks at
//    block 256), each one fmaf chain over the rows that continues across
//    row groups in order, in registers for the warp's first band and in
//    shared memory for the others; then it frees the stage.  So RK streams
//    each tile once, and holds a row group's 2*bands+1 stages at once.  At
//    the end of a pick GS (warp 0) adds beta * g to block row bi + bands;
//    RK adds band d's sums to block row bi + d of xw and dw.  A named
//    barrier closes the pick.
//
// Pick ids are checked on the device by check_picks (common.cuh) before
// the sweep.  Each C entry launches on the caller's stream and returns the
// error of cudaFuncSetAttribute (the stages exceed the 48 KB a launch gets
// without opting in), of a bad launch plan (cudaErrorInvalidValue), or
// cudaGetLastError() of the launch.
#include "common.cuh"

namespace {

constexpr int kMaxStageRows = 32;  // tile rows a stage holds: one a lane
constexpr int kSlices = 4;         // bulk copies a stage
constexpr int kConsumers = 15;     // most consumer warps; warp w owns bands w, w + 15, ...
constexpr int kMaxThreads = (kConsumers + 1) * 32;
constexpr int kMaxBlock = 256;
constexpr int kChunks = kMaxBlock / 4 / 32;  // 4-column chunks a lane owns in A^T gn
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) / 16 * 16; }

// A stage of R tile rows is kSlices slices of ceil(R / kSlices)
// consecutive rows, each slice one contiguous run of the tile (rows
// rounded up to 16 bytes), slices 16 bytes apart beyond that.  So row
// c * ceil(R / kSlices) + i of slice c starts on bank group
// (c * odd + i * row / 16) mod 8, and the lanes of a quarter warp (lane =
// kSlices * i + c) read kSlices distinct groups of banks: two lanes share
// one at kSlices = 4.
__host__ __device__ inline int row_pitch(int block, int itemsize) {
  return (int)round16((size_t)block * itemsize);
}
__host__ __device__ inline int slice_rows(int rows) { return (rows + kSlices - 1) / kSlices; }
__host__ __device__ inline int slice_pitch(int block, int itemsize, int rows) {
  return slice_rows(rows) * row_pitch(block, itemsize) + 16;
}

// Consumer warps of a launch: one a band, at most kConsumers.
__host__ __device__ inline int consumer_warps(int width) {
  return width < kConsumers ? width : kConsumers;
}

// Dynamic shared memory, in bytes from the base: the full, then the empty
// mbarriers of the stages (16 bytes a stage, rounded up to 256), the
// ring, the parts [2][width][R], g or gn [block], the Kaczmarz sums of the
// bands past the first kConsumers [width - kConsumers][block] (none at 7
// bands or fewer; GS leaves them unused), then the window column
// (shared-memory path) or the pick's 2*bands+1 blocks of it (global
// path).  kernels/banded_gs.py::smem_bytes mirrors it.
struct Layout {
  size_t ring, parts, gsave, accx, xs, total;
};

__host__ __device__ inline Layout band_layout(int block, int bands, int itemsize, int rows,
                                              int stages, int rows_w, bool shared) {
  const int width = 2 * bands + 1;
  Layout L;
  L.ring = (size_t)256 * ((stages + 15) / 16);
  L.parts = L.ring + (size_t)stages * kSlices * slice_pitch(block, itemsize, rows);
  L.gsave = L.parts + round16(sizeof(float) * 2 * width * rows);
  L.accx = L.gsave + round16(sizeof(float) * block);
  L.xs = L.accx + round16(sizeof(float) * (width - consumer_warps(width)) * block);
  L.total = L.xs + round16(sizeof(float) * (shared ? rows_w : (2 * bands + 1) * block));
  return L;
}

struct Args {
  const void* A;
  const float* b;
  const float* rn;
  float* xw;
  float* dw;
  const int* picks;
  const int* gates;
  int steps, bands, block, k, rows_w, rows, stages, bulk;
  float beta;
};

// ---- mbarriers and bulk copies (PTX, sm_90)

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete.  A wait never lasts
// more than a stage's copy or a pick's work; one that lasts kHangNs means
// a broken protocol, and traps rather than hanging the card.
constexpr uint64_t kHangNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = global_ns();
    else if (global_ns() - t0 > kHangNs)
      __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// The consumer warps only (named barrier 1; the producer never joins).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// ---- staged tile values, widened to f32

// 16 bytes of a staged row: 4 f32 or 8 bf16 values (16-byte aligned).
__device__ __forceinline__ void load16(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&a)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    a[2 * i] = f.x, a[2 * i + 1] = f.y;
  }
}

// 4 values of a staged row (aligned to 4 values).
__device__ __forceinline__ void load4(const float* p, float (&a)[4]) { load16(p, a); }
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&a)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  a[0] = lo.x, a[1] = lo.y, a[2] = hi.x, a[3] = hi.y;
}

// 4 rows of x from shared memory: one 16-byte load when x + j is 16-byte
// aligned (XVEC: block % 4 == 0), else one value a load.
template <bool XVEC>
__device__ __forceinline__ void load_x(const float* x, int j, float (&v)[4]) {
  if (XVEC) {
    const float4 q = *reinterpret_cast<const float4*>(x + j);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = x[j + i];
  }
}

// part = sum_j arow[j] * x[j] (fmaf, j = 0 ... block-1 in order), 16
// bytes of the row a step; every lane of the warp reads the same x.
template <typename V, bool XVEC>
__device__ __forceinline__ float row_part(const V* arow, const float* x, int block) {
  constexpr int E = 16 / sizeof(V);
  const int nch = block / E;
  float s = 0.f;
#pragma unroll 4
  for (int q = 0; q < nch; ++q) {
    float a[E];
    load16(arow + q * E, a);
#pragma unroll
    for (int h = 0; h < E; h += 4) {
      float v[4];
      load_x<XVEC>(x, q * E + h, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) s = fmaf(a[h + i], v[i], s);
    }
  }
  for (int j = nch * E; j < block; ++j) s = fmaf(to_f32(arow[j]), x[j], s);
  return s;
}

// acc[m][i] = fmaf(a[r][j], gn[r], acc[m][i]) for the tile columns
// j = 4 (lane + 32 m) + i the lane owns, over the `rows` staged rows of a
// row group in order: slice by slice, each slice's rows in turn.
template <typename V>
__device__ __forceinline__ void rows_at_gn(const V* st, const float* gn, int rows, int rs,
                                           int spitch, int rpitch, int block, int lane,
                                           float (&acc)[kChunks][4]) {
  for (int r0 = 0, c = 0; r0 < rows; r0 += rs, ++c) {
    const V* srow = st + c * spitch;
    const int n = min(rs, rows - r0);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float g = gn[r0 + i];
      const V* arow = srow + i * rpitch;
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const int j0 = 4 * (lane + 32 * m);
        if (j0 < block) {
          float a[4];
          load4(arow + j0, a);
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) acc[m][i4] = fmaf(a[i4], g, acc[m][i4]);
        }
      }
    }
  }
}

// MANY: more bands than consumer warps (2*bands+1 > kConsumers).
template <typename V, bool RK, bool SHARED, bool MANY>
__global__ void __launch_bounds__(kMaxThreads) banded_sweep_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int width = 2 * p.bands + 1;
  const int W = MANY ? kConsumers : width;
  const int consumers = W * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int block = p.block, k = p.k, R = p.rows, NS = p.stages;
  const int groups = (block + R - 1) / R;
  // in values: a staged row, a slice and a stage
  const int rs = slice_rows(R);
  const int rpitch = row_pitch(block, sizeof(V)) / (int)sizeof(V);
  const int spitch = slice_pitch(block, sizeof(V), R) / (int)sizeof(V);
  auto staged_row = [&](int r) { return (r / rs) * spitch + (r % rs) * rpitch; };
  const Layout L = band_layout(block, p.bands, sizeof(V), R, NS, p.rows_w, SHARED);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  V* ring = reinterpret_cast<V*>(smem + L.ring);
  float* parts = reinterpret_cast<float*>(smem + L.parts);
  float* gsave = reinterpret_cast<float*>(smem + L.gsave);
  float* accx = reinterpret_cast<float*>(smem + L.accx);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  const V* A = static_cast<const V*>(p.A);
  const int c0 = blockIdx.x;  // this CTA's column

  if (SHARED) {
#pragma unroll 8
    for (int i = threadIdx.x; i < p.rows_w; i += blockDim.x)
      xs[i] = p.xw[(size_t)i * k + c0];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const bool xvec = block % 4 == 0;

  if (warp == W) {
    // Producer: stage (pick, row group, band) t goes to slot t % NS.
    const int row_bytes = block * (int)sizeof(V);
    int cur = 0, nxt = lane < p.steps ? p.picks[lane] : 0;
    int slot = 0, lap = 0;
    for (int s = 0; s < p.steps; ++s) {
      if ((s & 31) == 0) {
        cur = nxt;
        nxt = s + 32 + lane < p.steps ? p.picks[s + 32 + lane] : 0;
      }
      const int bi = __shfl_sync(kFull, cur, s & 31);
      for (int g = 0; g < groups; ++g) {
        const int row0 = g * R, rows = min(R, block - row0);
        for (int d = 0; d < width; ++d) {
          if (lap > 0) mbar_wait(&empty[slot], (lap - 1) & 1);
          V* dst = ring + (size_t)slot * kSlices * spitch;
          const V* src = A + (((size_t)bi * width + d) * block + row0) * block;
          if (p.bulk) {
            // lane c copies slice c
            if (lane == 0) mbar_expect_tx(&full[slot], (uint32_t)(rows * row_bytes));
            __syncwarp();
            const int r0 = min(rows, lane * rs), n = min(rows - r0, rs);
            if (lane < kSlices && n > 0)
              bulk_copy(dst + lane * spitch, src + (size_t)r0 * block, n * row_bytes, &full[slot]);
          } else {
            for (int e = lane; e < rows * block; e += 32) {
              const int r = e / block, j = e - r * block;
              dst[staged_row(r) + j] = src[(size_t)r * block + j];
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&full[slot]);
          }
          if (++slot == NS) slot = 0, ++lap;
        }
      }
    }
  } else {
    // Consumer warp d: band d of every row group, in stage order, and with
    // MANY also bands d + W, d + 2W, ..., whose stages follow W apart (RK
    // keeps their sums in accx; the first band's stay in registers).
    const int d = warp;
    const int my_row = (lane % kSlices) * rs + lane / kSlices;  // in its row group
    const bool has_row = lane / kSlices < rs;
    int cur = 0, nxt = lane < p.steps ? p.picks[lane] : 0;
    int gcur = 0, gnxt = RK && lane < p.steps ? p.gates[lane] : 0;
    int slot = d % NS, lap = d / NS;  // this warp's stages are d, d + width, ...
    // warp 0: b (and rn) of row `lane` of a row group, loaded a group ahead
    float bnext = 0.f, rnext = 1.f;
    auto fetch_b = [&](int pick, int g) {
      const int r = g * R + lane;
      bnext = 0.f, rnext = 1.f;
      if (lane < R && r < block) {
        bnext = p.b[((size_t)pick * block + r) * k + c0];
        if (RK) rnext = p.rn[(size_t)pick * block + r];
      }
    };
    auto release = [&](int sl) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sl]);
    };
    if (warp == 0 && p.steps > 0) fetch_b(__shfl_sync(kFull, nxt, 0), 0);
    for (int s = 0; s < p.steps; ++s) {
      if ((s & 31) == 0) {
        cur = nxt;
        nxt = s + 32 + lane < p.steps ? p.picks[s + 32 + lane] : 0;
        if (RK) {
          gcur = gnxt;
          gnxt = s + 32 + lane < p.steps ? p.gates[s + 32 + lane] : 0;
        }
      }
      const int bi = __shfl_sync(kFull, cur, s & 31);
      const float betam = RK && __shfl_sync(kFull, gcur, s & 31) > 0 ? p.beta : 0.f;
      // RK: this warp's sums A_d^T gn (columns j = 4 (lane + 32 m) + i), and
      // the values of xw (global path) and dw they will be added to, loaded
      // now: nothing else writes these rows during the pick.
      float acc[kChunks][4], dold[kChunks][4];
      if (RK) {
#pragma unroll
        for (int m = 0; m < kChunks; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * (lane + 32 * m) + i;
            const size_t at = ((size_t)(bi + d) * block + j) * k + c0;
            acc[m][i] = 0.f;
            dold[m][i] = j < block ? p.dw[at] : 0.f;
          }
      }
      // x of the pick's blocks bi ... bi + 2*bands: the window in shared
      // memory, or (global path) a copy of those rows, taken once the
      // previous pick's writes are done.
      const float* xpick = SHARED ? xs + (size_t)bi * block : xs;
      if (!SHARED) {
        for (int i = threadIdx.x; i < width * block; i += consumers)
          xs[i] = p.xw[((size_t)bi * block + i) * k + c0];
        consumers_sync(consumers);
      }
      for (int g = 0; g < groups; ++g) {
        const int row0 = g * R, rows = min(R, block - row0);
        const float bval = bnext, rnval = rnext;
        if (warp == 0) {
          if (g + 1 < groups)
            fetch_b(bi, g + 1);
          else if (s + 1 < p.steps)
            fetch_b(((s + 1) & 31) ? __shfl_sync(kFull, cur, (s + 1) & 31)
                                   : __shfl_sync(kFull, nxt, 0), 0);
        }
        float* pg = parts + (g & 1) * width * R;
        // part_e of this lane's row from band e's stage
        auto part = [&](int e, const V* st) {
          if (has_row && my_row < rows) {
            const float* xb = xpick + e * block;
            const V* arow = st + staged_row(my_row);
            pg[e * R + my_row] =
                xvec ? row_part<V, true>(arow, xb, block) : row_part<V, false>(arow, xb, block);
          }
        };
        mbar_wait(&full[slot], lap & 1);
        const V* st = ring + (size_t)slot * kSlices * spitch;
        part(d, st);
        if (!RK) release(slot);
        if (MANY)
          for (int e = d + W, sl = slot, lp = lap; e < width; e += W) {
            sl += W, lp += sl / NS, sl %= NS;
            mbar_wait(&full[sl], lp & 1);
            part(e, ring + (size_t)sl * kSlices * spitch);
            if (!RK) release(sl);
          }
        consumers_sync(consumers);  // every part of this row group is in
        if (warp == 0 && lane < rows) {
          float gv = bval;
          for (int e = 0; e < width; ++e) gv = gv - pg[e * R + lane];
          gsave[row0 + lane] = RK ? __fdiv_rn(__fmul_rn(betam, gv), rnval) : gv;
        }
        if (RK) {
          consumers_sync(consumers);  // gn of this row group is in
          rows_at_gn(st, gsave + row0, rows, rs, spitch, rpitch, block, lane, acc);
          release(slot);
          if (MANY)
            for (int e = d + W, sl = slot; e < width; e += W) {
              sl = (sl + W) % NS;
              float* sums = accx + (size_t)(e - W) * block;
              float ax[kChunks][4];
#pragma unroll
              for (int m = 0; m < kChunks; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int j = 4 * (lane + 32 * m) + i;
                  ax[m][i] = g > 0 && j < block ? sums[j] : 0.f;
                }
              rows_at_gn(ring + (size_t)sl * kSlices * spitch, gsave + row0, rows, rs, spitch,
                         rpitch, block, lane, ax);
#pragma unroll
              for (int m = 0; m < kChunks; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int j = 4 * (lane + 32 * m) + i;
                  if (j < block) sums[j] = ax[m][i];
                }
              release(sl);
            }
        }
        slot += width, lap += slot / NS, slot %= NS;
      }
      if (!RK) {
        if (warp == 0) {
          __syncwarp();
          const size_t row0 = (size_t)(bi + p.bands) * block;
          for (int r = lane; r < block; r += 32) {
            const float x = __fadd_rn(xpick[p.bands * block + r], __fmul_rn(p.beta, gsave[r]));
            if (SHARED)
              xs[row0 + r] = x;
            else
              p.xw[(row0 + r) * k + c0] = x;
          }
        }
      } else {
        // band e's sum a goes to row j of block row bi + e of xw and dw
        auto put = [&](int e, int j, float a, float dv) {
          const size_t row = (size_t)(bi + e) * block + j;
          const float x = __fadd_rn(xpick[e * block + j], a);
          if (SHARED)
            xs[row] = x;
          else
            p.xw[row * k + c0] = x;
          p.dw[row * k + c0] = __fadd_rn(dv, a);
        };
#pragma unroll
        for (int m = 0; m < kChunks; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * (lane + 32 * m) + i;
            if (j < block) put(d, j, acc[m][i], dold[m][i]);
          }
        if (MANY)
          for (int e = d + W; e < width; e += W) {
            const float* sums = accx + (size_t)(e - W) * block;
#pragma unroll
            for (int m = 0; m < kChunks; ++m)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int j = 4 * (lane + 32 * m) + i;
                if (j < block) put(e, j, sums[j], p.dw[((size_t)(bi + e) * block + j) * k + c0]);
              }
          }
      }
      consumers_sync(consumers);  // the next pick reads what this one wrote
    }
    if (SHARED)
      for (int i = threadIdx.x; i < p.rows_w; i += consumers) p.xw[(size_t)i * k + c0] = xs[i];
  }
}

template <typename V, bool RK>
int launch(Args a, int shared, cudaStream_t stream) {
  const int width = 2 * a.bands + 1;
  const int row_bytes = a.block * (int)sizeof(V);
  a.bulk = row_bytes % 16 == 0 && (uintptr_t)a.A % 16 == 0;
  if (a.bands < 0 || a.block < 1 || a.block > kMaxBlock || a.rows < 1 ||
      a.rows > kMaxStageRows || a.stages < 1 || (RK && a.stages < width))
    return (int)cudaErrorInvalidValue;
  const Layout L = band_layout(a.block, a.bands, sizeof(V), a.rows, a.stages, a.rows_w, shared);
  void (*kernel)(const Args) =
      width > kConsumers ? (shared ? banded_sweep_kernel<V, RK, true, true>
                                   : banded_sweep_kernel<V, RK, false, true>)
                         : (shared ? banded_sweep_kernel<V, RK, true, false>
                                   : banded_sweep_kernel<V, RK, false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)a.k, (unsigned)((consumer_warps(width) + 1) * 32), L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define BANDED_GS_ENTRY(NAME, V)                                                                 \
  extern "C" int NAME(const void* A, const void* b, void* xw, const void* picks, int steps,     \
                      int limit, int bands, int block, int k, float beta, int shared, int rows,  \
                      int stages, void* stream) {                                                \
    launch_check(picks, steps, limit, (cudaStream_t)stream);                                     \
    Args a = {A, (const float*)b, nullptr, (float*)xw, nullptr, (const int*)picks, nullptr,     \
              steps, bands, block, k, (limit + 2 * bands) * block, rows, stages, 0, beta};       \
    return launch<V, false>(a, shared, (cudaStream_t)stream);                                    \
  }

#define BANDED_RK_ENTRY(NAME, V)                                                                 \
  extern "C" int NAME(const void* A, const void* b, const void* rn, void* xw, void* dw,          \
                      const void* picks, const void* gates, int steps, int limit, int bands,     \
                      int block, int k, float beta, int shared, int rows, int stages,            \
                      void* stream) {                                                            \
    launch_check(picks, steps, limit, (cudaStream_t)stream);                                     \
    Args a = {A, (const float*)b, (const float*)rn, (float*)xw, (float*)dw, (const int*)picks,  \
              (const int*)gates, steps, bands, block, k, (limit + 2 * bands) * block, rows,      \
              stages, 0, beta};                                                                  \
    return launch<V, true>(a, shared, (cudaStream_t)stream);                                     \
  }

BANDED_GS_ENTRY(banded_gs_sweep_f32, float)
BANDED_GS_ENTRY(banded_gs_sweep_bf16, __nv_bfloat16)
BANDED_RK_ENTRY(banded_rk_sweep_f32, float)
BANDED_RK_ENTRY(banded_rk_sweep_bf16, __nv_bfloat16)
