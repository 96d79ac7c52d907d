// Fused sequential sweeps over padded sparse rows: coordinate Gauss-Seidel
// and Kaczmarz, the latter also on two carries, and block Gauss-Seidel over
// aligned panels of rows (its note is above the block GS kernels below).
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
// Updates are rounded explicitly, as the plain versions round them: GS
// x + (beta * (b - dot)), RK (beta * v) then * g, then the add
// (__fsub_rn / __fmul_rn / __fadd_rn: no contraction to an FMA).  So both
// carries of the delta sweep see bitwise the same contributions in the
// same order (from x = d = 0 the two outputs are bitwise equal), and the
// two paths of each sweep below are bitwise equal.
//
// What bounds them.  Each step reads what the previous step wrote, so a
// column is one chain of `steps` dependent steps.  The bytes a step needs
// (one row window, one b row) are a few hundred; the roofline bound from
// bytes is far below what the chain's latency allows.  The kernels are
// latency-bound, and their time per pick is the number to watch.
//
// RHS columns are independent (each has its own gamma), so one warp owns
// one column: the sequential grid of the Pallas kernel becomes a loop over
// picks inside the warp.  At each step lane l takes the slots l, l + 32,
// ... of the row window in that order (fmaf), the warp reduces with the
// butterfly of warp_sum, and the update follows; __syncwarp() closes the
// step so the next step's gathers see its writes (a column never spans
// warps, so no block barrier is needed).
//
// GS.  A step's dependent chain is the gather of x, the fmaf, the
// reduction and the update; nothing else waits on x:
//  (a) The pick ids, the row windows and b do not depend on x, so they
//      are fetched ahead: the warp loads the ids 32 at a time (lane l holds
//      picks[s0 + l], broadcast by __shfl_sync) and keeps the first
//      kGsSlots * 32 slots of the windows and the b value of the next
//      kGsDepth picks in a register ring.  Slots past that (rows wider
//      than 64) are loaded in the step, in the same slot order.  The row a
//      step updates is read with its gathers, not after the reduction.
//      The depth, 32 picks (one batch of ids), was the fastest of 8, 16
//      and 32 on both paths (PERF.md).
//  (b) Shared-memory path: a CTA owns one RHS column and copies x[0:n, c]
//      into dynamic shared memory at the start, gathers from and writes
//      to it, and writes the column back at the end.  All n rows are
//      held: write_base + r may be any row of x.  The launcher takes this
//      path when 4 n bytes fit the opt-in capacity (sweep_shared_capacity;
//      227 KB on an H100: n <= 58112).  What is left of a step is a
//      shared-memory gather, the five shuffle levels of the butterfly and
//      the update: a few hundred cycles, against the three dependent L2
//      round trips of the first version.  Two or three columns a CTA were
//      no faster on a main-path chunk and slower on short sweeps (PERF.md).
//  (c) Global path, for n above that: the same warp code with x in global
//      memory, four columns a CTA; its gather is an L2 round trip.
//  (d) Both paths run the same step function, slot order, butterfly and
//      explicitly rounded update, so on the same inputs they are
//      bitwise equal.  The launcher (kernels/sweep_csr.py) chooses the
//      path by size; it is not a fallback: both run on the card.
//
// RK.  A step is the same kind of chain, with a longer tail: the gather,
// the fmaf, the butterfly (four levels when a row has at most 16 slots),
// g = (b - dot) / rn (IEEE division, as the plain version divides),
// (beta * v) * g and the scatter-add.  The design is the
// GS design above, point for point:
//  (a) Everything that does not depend on x is loaded ahead.  Lane l
//      holds the ids of picks s0 + l and s0 + 32 + l (loaded two batches
//      ahead) and b[r, c] and rn[r] of pick s0 + l (one batch ahead); a
//      step takes its own by __shfl_sync, and every lane computes g, so
//      no shuffle sits between the division and the scatter.  A register
//      ring holds the next kRkDepth picks' first kRkSlots * 32 window
//      slots (value and column); slots past that (rows wider than 32) go
//      through the out-of-line tails in the same slot order.  The scatter
//      adds to the x value the gather read: no step writes a real slot's
//      column between the two (the real columns of a row are distinct, and
//      one warp owns the column), so the update costs no second load.  The
//      delta sweep loads d with the gathers (no step reads d, so nothing
//      waits on that load).  Depth 32 was faster than 8 and 16, and this
//      ring (two registers a pick) faster than one that also held the row,
//      b and rn of each pick (five a pick; it spilled) (PERF.md).
//  (b) Shared-memory path: a CTA owns one RHS column and copies x[0:n, c]
//      (and d[0:n, c]) into dynamic shared memory, sweeps there, and writes
//      them back.  The launcher takes it when 4 n bytes per carry fit the
//      opt-in capacity (kernels/sweep_csr.py::fits_shared; the
//      main-path LSQ has n = 4096: 16 KB, 32 KB with d).
//  (c) Global path, for n above that: the same warp code with x (and d)
//      in global memory, kColsPerBlock columns a CTA.
//  (d) Both paths run the same step function, slot order, butterfly and
//      explicitly rounded arithmetic, so on the same inputs they are
//      bitwise equal; a column's steps never read another column, so
//      column 0 at k = 51 is bitwise column 0 at k = 1.
// Padding slots (value 0, column 0; operators.CsrOp.padded_rows) are a race
// for a parallel RK scatter: several lanes would update x[0, c] at once.
// The RK scatter therefore skips slots whose value is 0, which adds the same
// exact zero the sequential Pallas scatter adds.  Real columns of one row
// are distinct, so the remaining lane writes never collide.
//
// Pick ids are checked on the device (0 <= r < limit) with assert(), as
// PyTorch's indexing kernels check theirs, by a small kernel launched just
// before the sweep on the same stream (check_picks in common.cuh): a bad
// id stops there with a device-side assert, and the sweep queued behind it
// never runs.  The host never reads the picks back.  The check stays out
// of the sweep's loop: an assert inside the dependent chain made the
// sweeps 11-15% slower (chip_smoke.py on an H100 80GB HBM3 at 700 W;
// PERF.md).
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError() of the launch (for a shared-memory path, first the
// error of cudaFuncSetAttribute, which opts into the shared memory).
#include "common.cuh"

namespace {

constexpr int kColsPerBlock = 4;  // warps (RHS columns) per block

constexpr int kGsDepth = 32;          // picks whose windows are fetched ahead
static_assert(32 % kGsDepth == 0, "the ring depth divides the 32 ids a warp loads");
constexpr int kGsSlots = 2;           // window slots a lane holds per pick
constexpr int kGsSharedThreads = 256; // CTA of the shared-memory path
constexpr unsigned kFull = 0xffffffffu;

// What a GS step needs that does not depend on x: the pick's row, the
// lane's first kGsSlots slots of its window and (lane 0) its b value.
struct GsWindow {
  int r;
  float b;
  float v[kGsSlots];
  int col[kGsSlots];
};

template <typename V, typename I>
__device__ __forceinline__ void gs_fetch(GsWindow& w, int r, const V* __restrict__ vals,
                                         const I* __restrict__ cols, const float* __restrict__ b,
                                         int width, int k, int c, int lane) {
  const size_t base = (size_t)r * width;
  w.r = r;
#pragma unroll
  for (int q = 0; q < kGsSlots; ++q) {
    const int s = lane + 32 * q;
    w.v[q] = s < width ? to_f32(vals[base + s]) : 0.f;
    w.col[q] = s < width ? (int)cols[base + s] : 0;
  }
  w.b = lane == 0 ? b[(size_t)r * k + c] : 0.f;
}

// Row `row` of a column: x in shared memory holds the column contiguously,
// in global memory its rows are k floats apart.
template <bool kShared>
__device__ __forceinline__ float& x_at(float* xc, int row, int k) {
  if constexpr (kShared) {
    return xc[row];
  } else {
    return xc[(size_t)row * k];
  }
}

// The slots of a row window from kFrom on, in the step's slot order, added
// to a lane's dot.  Kept out of line: inlined into every step of the
// unrolled loop, this rarely taken code made the loop too large for the
// instruction cache, and every step paid for the misses (PERF.md).
template <int kFrom, bool kShared, typename V, typename I>
__device__ __noinline__ float window_tail(float* xc, int k, int r, const V* __restrict__ vals,
                                          const I* __restrict__ cols, int width, int lane,
                                          float acc) {
  const size_t base = (size_t)r * width;
  for (int s = lane + kFrom; s < width; s += 32)
    acc = fmaf(to_f32(vals[base + s]), x_at<kShared>(xc, (int)cols[base + s], k), acc);
  return acc;
}

// One GS step on column xc: the dependent chain.  The row it updates is
// read with the gathers (every lane, one address), not after the
// reduction, so on the global path it costs no round trip of its own.
// (No step writes x between that read and this step's update.)
template <bool kShared, typename V, typename I>
__device__ __forceinline__ void gs_step(float* xc, int k, const GsWindow& w,
                                        const V* __restrict__ vals, const I* __restrict__ cols,
                                        int width, int write_base, float beta, int lane) {
  float& xr = x_at<kShared>(xc, write_base + w.r, k);
  const float old = xr;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kGsSlots; ++q)
    if (lane + 32 * q < width) acc = fmaf(w.v[q], x_at<kShared>(xc, w.col[q], k), acc);
  if (width > 32 * kGsSlots)
    acc = window_tail<32 * kGsSlots, kShared>(xc, k, w.r, vals, cols, width, lane, acc);
  const float dot = warp_sum(acc);
  if (lane == 0) xr = __fadd_rn(old, __fmul_rn(beta, __fsub_rn(w.b, dot)));
  __syncwarp();
}

// The whole sweep of one warp on its column c (xc: the column's row 0).
// The step loop is unrolled by the ring depth, so that every ring slot is
// a compile-time constant (the ring stays in registers), and no further:
// with only one warp on a column, a longer unrolled loop stalls on
// instruction fetch (PERF.md).
template <bool kShared, typename V, typename I>
__device__ __forceinline__ void gs_warp_sweep(float* xc, int k, int c, const V* __restrict__ vals,
                                              const I* __restrict__ cols,
                                              const float* __restrict__ b,
                                              const int* __restrict__ picks, int width, int steps,
                                              int write_base, float beta, int lane) {
  GsWindow ring[kGsDepth];
  // Past the last step the ids are 0: row 0 exists whenever there is a step.
  int ids = lane < steps ? picks[lane] : 0;
#pragma unroll
  for (int u = 0; u < kGsDepth; ++u)
    gs_fetch(ring[u], __shfl_sync(kFull, ids, u), vals, cols, b, width, k, c, lane);
  for (int s0 = 0; s0 < steps; s0 += 32) {
    const int next = s0 + 32 + lane < steps ? picks[s0 + 32 + lane] : 0;
#pragma unroll 1
    for (int g = 0; g < 32; g += kGsDepth) {
#pragma unroll
      for (int j = 0; j < kGsDepth; ++j) {
        const int u = g + j;
        if (s0 + u >= steps) return;  // warp-uniform: the last step is done
        gs_step<kShared>(xc, k, ring[j], vals, cols, width, write_base, beta, lane);
        const int t = u + kGsDepth;  // the step whose window refills this slot
        const int r = __shfl_sync(kFull, t < 32 ? ids : next, t & 31);
        if (s0 + t < steps) gs_fetch(ring[j], r, vals, cols, b, width, k, c, lane);
      }
    }
    ids = next;
  }
}

// kShared: the shared-memory path, one column a CTA (blockDim
// kGsSharedThreads: all of them copy, warp 0 sweeps); otherwise the global
// path, kColsPerBlock columns a CTA.  x is read and written by the same
// warp across steps: it is not declared __restrict__ const, so its loads
// are never routed through the read-only (non-coherent) cache.
template <typename V, typename I, bool kShared>
__global__ void __launch_bounds__(kGsSharedThreads)
    gs_kernel(const V* __restrict__ vals, const I* __restrict__ cols, const float* __restrict__ b,
              float* x, const int* __restrict__ picks, int width, int n, int k, int steps,
              int write_base, float beta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kShared) {
    extern __shared__ float xs[];
    const int c = blockIdx.x;
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) xs[row] = x[(size_t)row * k + c];
    __syncthreads();
    if (warp == 0)
      gs_warp_sweep<true>(xs, k, c, vals, cols, b, picks, width, steps, write_base, beta, lane);
    __syncthreads();
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) x[(size_t)row * k + c] = xs[row];
  } else {
    const int c = blockIdx.x * kColsPerBlock + warp;
    if (c >= k) return;  // warp-uniform
    gs_warp_sweep<false>(x + c, k, c, vals, cols, b, picks, width, steps, write_base, beta, lane);
  }
}

// Block GS (gs_block > 1 on CSR; no TPU kernel: the reference's scan
// computes b[rows] - A[rows, :] @ x on a densified row panel,
// src/repro/core/engine.py:580-590).  Pick bi owns the rows bi * block + j,
// j < block.  Per RHS column, every row's dot reads x before the pick
// writes any of them:
//   gamma_j = b[row_j, c] - sum_w vals[row_j, w] * x[cols[row_j, w], c]
//   x[row_j, c] += beta * gamma_j                     (after every gamma)
// A row's dot is the GS step's: the partial sum of position l (l < 32)
// adds the slots l, l + 32, ... in that order (fmaf from +0), and the 32
// partials are added by warp_sum's butterfly (position l and l ^ o at o =
// 16, 8, 4, 2, 1).  The update is rounded the same way, so at block = 1 the
// sweep is bitwise sweep_rows_gs, and both designs below are bitwise equal.
//
// What bounds it.  The picks are a chain; a pick's rows are independent.
// A CTA owns one RHS column (grid k), so a pick costs the latency of its
// slowest row's dot plus the CTA's synchronization, and every column's CTA
// reads the same windows.
//
// The ring design (bgs_ring_kernel), whenever the ring's stages fit:
//  (a) A producer warp streams each pick's row windows (in the padded
//      rows, pick bi's rows are one contiguous run of block * width values
//      and as many ids) into a ring of kRingStages stages in dynamic
//      shared memory with cp.async.bulk, each stage completing on its own
//      mbarrier, up to kRingStages tiles ahead of the chain (2 to 16
//      stages timed alike at blocks 8 and 128; at block 1000 two stages
//      leave room for larger tiles, which won: PERF.md).  A bulk copy
//      needs 16-byte-aligned addresses and sizes: the launcher hands
//      16-byte-aligned bases, the copy starts at the aligned element below
//      the run, and the ragged end (under 16 bytes) is loaded by producer
//      lanes, which arrive on the stage's barrier after their stores.  No
//      byte past the run's last element is read.  The tile's b values of
//      the CTA's column (strided in b) come into the stage by 4-byte
//      cp.async, tracked by the same barrier.  A pick larger than a stage
//      goes through the ring in tiles of `tile_rows` rows.
//  (b) `warps` consumer warps take a tile's rows, `rows` = 32 / `lanes` a
//      warp: a group of `lanes` lanes owns a row, lane i of it holding the
//      partials of the positions l = i (mod lanes), so the butterfly's
//      levels o >= lanes add in registers (in the same pairs) and only
//      log2(lanes) levels shuffle.  The dots read values and ids from the
//      stage; only the x gathers, the sums and the update are on the
//      chain (a first version loaded b two picks ahead into registers:
//      rotating them made every pick wait for an L2 load; PERF.md).  The
//      old x of a row is read with the gathers.  The lane that owns a row
//      writes it, so no gamma is staged unless a pick spans several tiles
//      (then the earlier tiles' gammas go to a (k, block) scratch, each
//      read back by the thread that wrote it).
//  (c) Two points of order a pick: every dot has read x before any row is
//      written, and the writes are seen by the next pick's gathers.  One
//      consumer warp closes each with __syncwarp(); several, with a named
//      barrier over the consumer warps only (bar.sync 1).  The launcher
//      takes min(8, block) warps: at block 8 eight warps, a warp a row,
//      beat one warp holding all eight rows (PERF.md).  A consumer warp
//      releases a stage (its lane 0 arrives on the stage's empty barrier)
//      after a __syncwarp() that follows its reads of it; the producer
//      waits for that, then fences the async proxy before the next copy
//      lands there.
//  (d) x: the shared-memory path holds x[0:n, c] beside the ring; the
//      global path keeps it in global memory and still streams the windows
//      (both chosen by size: kernels/sweep_csr.py::block_plan).  There the
//      gathers are L2 round trips, and for picks of more than 8 rows (30
//      and 128) the ring was no faster than the first design, which the
//      launcher then runs.
//
// The first design (bgs_kernel), kept for rows too wide for a ring of
// one-row stages and for the global path's picks of more than 8 rows: eight
// warps take a pick's rows four at a time, reading the windows from
// global memory, stage each gamma, and after a CTA barrier its threads
// add them to the rows.  Its shared-memory path holds x[0:n, c] and the
// gammas (n + block floats); its global path stages the gammas in the
// scratch.
constexpr int kBgsThreads = 256;
constexpr int kBgsWarps = kBgsThreads / 32;
constexpr int kBgsGroup = 4;

// Row r's dot with column xc in the GS step's slot order (gs_step's
// arithmetic; every lane ends with the same value).
template <bool kShared, typename V, typename I>
__device__ __forceinline__ float bgs_row_dot(float* xc, int k, int r, const V* __restrict__ vals,
                                             const I* __restrict__ cols, int width, int lane) {
  const size_t base = (size_t)r * width;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kGsSlots; ++q) {
    const int s = lane + 32 * q;
    if (s < width) acc = fmaf(to_f32(vals[base + s]), x_at<kShared>(xc, (int)cols[base + s], k), acc);
  }
  if (width > 32 * kGsSlots)
    acc = window_tail<32 * kGsSlots, kShared>(xc, k, r, vals, cols, width, lane, acc);
  return warp_sum(acc);
}

// The whole sweep of one CTA on its column c (xc: the column's row 0;
// gam: the column's block staged gammas).
template <bool kShared, typename V, typename I>
__device__ __forceinline__ void bgs_cta_sweep(float* xc, float* __restrict__ gam, int k, int c,
                                              const V* __restrict__ vals,
                                              const I* __restrict__ cols,
                                              const float* __restrict__ b,
                                              const int* __restrict__ picks, int width, int steps,
                                              int block, float beta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int bi = picks[0];
  for (int s = 0; s < steps; ++s) {
    const int next = s + 1 < steps ? picks[s + 1] : 0;
    const int row0 = bi * block;
    for (int j0 = warp * kBgsGroup; j0 < block; j0 += kBgsWarps * kBgsGroup) {
      float dot[kBgsGroup], br[kBgsGroup];
#pragma unroll
      for (int u = 0; u < kBgsGroup; ++u) {
        const int r = row0 + min(j0 + u, block - 1);  // warp-uniform
        br[u] = b[(size_t)r * k + c];
        dot[u] = bgs_row_dot<kShared>(xc, k, r, vals, cols, width, lane);
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kBgsGroup; ++u)
          if (j0 + u < block) gam[j0 + u] = __fsub_rn(br[u], dot[u]);
      }
    }
    __syncthreads();  // every dot has read x; the gammas are staged
    for (int j = threadIdx.x; j < block; j += kBgsThreads) {
      float& xr = x_at<kShared>(xc, row0 + j, k);
      xr = __fadd_rn(xr, __fmul_rn(beta, gam[j]));
    }
    __syncthreads();  // the pick's writes are seen by the next pick's dots
    bi = next;
  }
}

// One CTA (kBgsThreads) a column on both paths.  kShared: x[0:n, c] and
// the gammas in dynamic shared memory; otherwise x in global memory and
// the gammas in scratch[c * block, (c + 1) * block).
template <typename V, typename I, bool kShared>
__global__ void __launch_bounds__(kBgsThreads)
    bgs_kernel(const V* __restrict__ vals, const I* __restrict__ cols, const float* __restrict__ b,
               float* x, float* scratch, const int* __restrict__ picks, int width, int n, int k,
               int steps, int block, float beta) {
  const int c = blockIdx.x;
  if constexpr (kShared) {
    extern __shared__ float xs[];
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) xs[row] = x[(size_t)row * k + c];
    __syncthreads();
    bgs_cta_sweep<true>(xs, xs + n, k, c, vals, cols, b, picks, width, steps, block, beta);
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) x[(size_t)row * k + c] = xs[row];
  } else {
    bgs_cta_sweep<false>(x + c, scratch + (size_t)c * block, k, c, vals, cols, b, picks, width,
                         steps, block, beta);
  }
}

// ---- The ring design ----
constexpr int kRingWarps = 8;     // consumer warps at most
constexpr int kRingStages = 2;    // stages of the ring (kernels/sweep_csr.py::RING_STAGES)
constexpr int kRingThreads = 32 * (kRingWarps + 1);
constexpr long long kHangCycles = 1ll << 32;  // a wait this long (about 2 s) traps

// Bytes of one stage region holding `rows` rows of `elem`-byte elements at
// an offset under 16 bytes (kernels/sweep_csr.py::ring_region).
__host__ __device__ __forceinline__ size_t ring_region(int rows, int width, size_t elem) {
  return ((size_t)rows * width * elem + 15 + 15) & ~(size_t)15;
}

// Bytes of a stage: the tile's values, its ids, and its rows' b values of
// the CTA's column (kernels/sweep_csr.py::ring_bytes).
template <typename V, typename I>
__host__ __device__ __forceinline__ size_t ring_stage_bytes(int rows, int width) {
  return ring_region(rows, width, sizeof(V)) + ring_region(rows, width, sizeof(I)) +
         (((size_t)rows * sizeof(float) + 15) & ~(size_t)15);
}

// Dynamic shared memory of the ring kernel: the stages' barriers (full and
// empty, 8 bytes each), x on the shared-memory path, the stages
// (kernels/sweep_csr.py::ring_bytes).
template <typename V, typename I>
size_t ring_smem_bytes(int n, int width, int tile_rows, bool shared) {
  const size_t xb = shared ? ((size_t)n * sizeof(float) + 15) & ~(size_t)15 : 0;
  return 16 * (size_t)kRingStages + xb + kRingStages * ring_stage_bytes<V, I>(tile_rows, width);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits out of line: a stage that is late, or a barrier that never
// completes, which traps (a launch error) instead of hanging the card.
// Each try suspends the thread until the phase completes or a millisecond
// passes, so a waiting warp does not spin.
__device__ __noinline__ void mbar_wait_slow(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(1000000u)
        : "memory");
    if (!done && clock64() - t0 > kHangCycles) __trap();
  }
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (!mbar_try(bar, parity)) mbar_wait_slow(bar, parity);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// A 4-byte asynchronous copy (cp.async), and an arrival on the barrier
// that the executing thread's earlier such copies trigger when they land.
__device__ __forceinline__ void async_copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void async_copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The two points of order of a pick, over the consumer warps only.
__device__ __forceinline__ void consumers_sync(int warps) {
  if (warps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(32 * warps) : "memory");
}

// The producer warp: every tile of every pick into the ring, in order.
// Element e of a run [e0, e1) lands at element e - a of its stage region,
// a = e0 rounded down to 16 bytes: lane 0 bulk-copies [a, m), m = e1
// rounded down, and lanes 1-15 (values) and 16-31 (ids) load the ragged
// end [m, e1), one element each.  The tile's b values of column c (a
// column of b is strided) go by 4-byte cp.async, lane j > 0 taking rows j
// - 1, j + 30, ..., so that lane 0's proxy fence has no copy of its own
// in flight; each lane's async arrival waits for its copies.  Every lane
// also arrives on the stage's full barrier (count 32), lane 0 with the
// bulk copies' bytes.
template <typename V, typename I>
__device__ __forceinline__ void ring_produce(const V* __restrict__ vals, const I* __restrict__ cols,
                                             const float* __restrict__ b, int k, int c,
                                             const int* __restrict__ picks, int steps, int width,
                                             int block, int tile_rows, unsigned char* ring,
                                             size_t vregion, size_t bregion, size_t sbytes,
                                             uint64_t* full, uint64_t* empty, int lane) {
  constexpr int kPerV = 16 / sizeof(V), kPerI = 16 / sizeof(I);
  int st = 0;
  uint32_t phase = 0;
  int ids = lane < steps ? picks[lane] : 0;
  for (int s0 = 0; s0 < steps; s0 += 32) {
    const int next = s0 + 32 + lane < steps ? picks[s0 + 32 + lane] : 0;
    const int batch = min(32, steps - s0);
    for (int u = 0; u < batch; ++u) {
      const size_t row0 = (size_t)__shfl_sync(kFull, ids, u) * block;
      for (int t0 = 0; t0 < block; t0 += tile_rows) {
        const int rows = min(tile_rows, block - t0);
        const size_t e0 = (row0 + t0) * width;
        const size_t e1 = e0 + (size_t)rows * width;
        const size_t av = e0 / kPerV * kPerV, mv = e1 / kPerV * kPerV;
        const size_t ac = e0 / kPerI * kPerI, mc = e1 / kPerI * kPerI;
        V* sv = reinterpret_cast<V*>(ring + st * sbytes);
        I* sc = reinterpret_cast<I*>(ring + st * sbytes + vregion);
        float* sb = reinterpret_cast<float*>(ring + st * sbytes + bregion);
        const uint32_t fb = smem_u32(&full[st]);
        mbar_wait(smem_u32(&empty[st]), phase ^ 1);
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          const uint32_t bv = (uint32_t)((mv - av) * sizeof(V));
          const uint32_t bc = (uint32_t)((mc - ac) * sizeof(I));
          mbar_arrive_tx(fb, bv + bc);
          if (bv) bulk_load(smem_u32(sv), vals + av, bv, fb);
          if (bc) bulk_load(smem_u32(sc), cols + ac, bc, fb);
        } else {
          for (int j = lane - 1; j < rows; j += 31)
            async_copy4(smem_u32(&sb[j]), &b[(row0 + t0 + j) * k + c]);
          async_copies_arrive(fb);
          if (lane < 16) {
            const size_t e = mv + lane - 1;
            if (e < e1) sv[e - av] = vals[e];
          } else {
            const size_t e = mc + lane - 16;
            if (e < e1) sc[e - ac] = (I)(int)cols[e];
          }
          mbar_arrive(fb);
        }
        if (++st == kRingStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    ids = next;
  }
}

// The dot of a row whose window starts at vs / cs in a stage, by the
// `kLanes` lanes of its group (lane i of the group: partials of the
// positions l = i + kLanes * m), in the GS step's order and pairs (the
// note above); every lane of the group ends with the same value.  With x
// in shared memory each round of 32 slots loads all its values and ids
// first (slots past the row read its last slot, and add nothing), then
// all its gathers, then adds: written slot by slot, the compiler chained
// each slot's loads behind the previous slot's add.  With x in global
// memory the slot-by-slot form was faster (PERF.md).  A lane of an
// inactive group loads nothing (its partials stay +0) but shuffles.
template <int kLanes, bool kShared, typename V, typename I>
__device__ __forceinline__ float ring_row_dot(float* xc, int k, const V* vs, const I* cs,
                                              int width, bool active, int i) {
  constexpr int kParts = 32 / kLanes;
  float p[kParts];
#pragma unroll
  for (int m = 0; m < kParts; ++m) p[m] = 0.f;
  if (active && !kShared) {
#pragma unroll 1
    for (int q0 = i; q0 < width; q0 += 32) {
#pragma unroll
      for (int m = 0; m < kParts; ++m) {
        const int s = q0 + kLanes * m;
        if (s < width) p[m] = fmaf(to_f32(vs[s]), x_at<false>(xc, (int)cs[s], k), p[m]);
      }
    }
  } else if (active) {
#pragma unroll 1
    for (int q0 = i; q0 < width; q0 += 32) {
      float v[kParts], g[kParts];
      int col[kParts];
#pragma unroll
      for (int m = 0; m < kParts; ++m) {
        const int s = min(q0 + kLanes * m, width - 1);
        v[m] = to_f32(vs[s]);
        col[m] = (int)cs[s];
      }
#pragma unroll
      for (int m = 0; m < kParts; ++m) g[m] = x_at<kShared>(xc, col[m], k);
#pragma unroll
      for (int m = 0; m < kParts; ++m)
        if (q0 + kLanes * m < width) p[m] = fmaf(v[m], g[m], p[m]);
    }
  }
#pragma unroll
  for (int h = kParts / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int m = 0; m < kParts / 2; ++m)
      if (m < h) p[m] += p[m + h];
  }
  float v = p[0];
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One consumer warp's part of the sweep on column xc (gam: the column's
// scratch, for picks of several tiles).  Its lanes own rows warp * rows +
// lane / kLanes of each tile; lane i == 0 of a group reads the row's b
// from the stage and its old x with the gathers, and writes the row.
// Indices into a pick are 32-bit (a row of x is an int); only the
// window's offset in its 16-byte granule needs the run's start, mod 16.
template <int kLanes, bool kShared, typename V, typename I>
__device__ __forceinline__ void ring_consume(float* xc, float* gam, int k,
                                             const int* __restrict__ picks, int steps, int width,
                                             int block, int tile_rows, int warps,
                                             float beta, const unsigned char* ring,
                                             size_t vregion, size_t bregion, size_t sbytes,
                                             uint64_t* full, uint64_t* empty, int warp,
                                             int lane) {
  constexpr int kRows = 32 / kLanes;
  constexpr unsigned kPerV = 16 / sizeof(V), kPerI = 16 / sizeof(I);
  const int i = lane % kLanes, jt = warp * kRows + lane / kLanes;
  const int last_t0 = (block - 1) / tile_rows * tile_rows;  // the last tile's first row
  const bool writes_last = i == 0 && jt < block - last_t0;
  const unsigned char* stage = ring;
  int st = 0;
  uint32_t phase = 0;
  int ids = lane < steps ? picks[lane] : 0;
  for (int s0 = 0; s0 < steps; s0 += 32) {
    const int next = s0 + 32 + lane < steps ? picks[s0 + 32 + lane] : 0;
    const int batch = min(32, steps - s0);
    for (int u = 0; u < batch; ++u) {
      const int row0 = __shfl_sync(kFull, ids, u) * block;
      float gamma = 0.f;
      const float xold = writes_last ? x_at<kShared>(xc, row0 + last_t0 + jt, k) : 0.f;
      for (int t0 = 0; t0 < block; t0 += tile_rows) {
        const bool active = jt < min(tile_rows, block - t0);
        const unsigned e0 = (unsigned)(row0 + t0) * (unsigned)width;  // mod 2^32
        const V* vs = reinterpret_cast<const V*>(stage) + (e0 & (kPerV - 1));
        const I* cs = reinterpret_cast<const I*>(stage + vregion) + (e0 & (kPerI - 1));
        const float* sb = reinterpret_cast<const float*>(stage + bregion);
        mbar_wait(smem_u32(&full[st]), phase);
        const float br = active && i == 0 ? sb[jt] : 0.f;
        const float dot = ring_row_dot<kLanes, kShared>(xc, k, vs + jt * width, cs + jt * width,
                                                        width, active, i);
        __syncwarp();  // the warp's reads of the stage are done
        if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
        if (active && i == 0) {
          const float g = __fsub_rn(br, dot);
          if (t0 == last_t0)
            gamma = g;
          else
            gam[t0 + jt] = g;
        }
        stage += sbytes;
        if (++st == kRingStages) {
          st = 0;
          stage = ring;
          phase ^= 1;
        }
      }
      consumers_sync(warps);  // every dot of the pick has read x
      for (int t0 = 0; t0 < last_t0; t0 += tile_rows) {
        if (i == 0 && jt < tile_rows) {
          float& xr = x_at<kShared>(xc, row0 + t0 + jt, k);
          xr = __fadd_rn(xr, __fmul_rn(beta, gam[t0 + jt]));
        }
      }
      if (writes_last)
        x_at<kShared>(xc, row0 + last_t0 + jt, k) = __fadd_rn(xold, __fmul_rn(beta, gamma));
      consumers_sync(warps);  // the pick's writes are seen by the next pick's dots
    }
    ids = next;
  }
}

// One CTA a column: `warps` consumer warps and the producer warp after
// them.  Dynamic shared memory: the stages' barriers, x[0:n, c] (kShared),
// the ring (ring_smem_bytes).
template <typename V, typename I, int kLanes, bool kShared>
__global__ void __launch_bounds__(kRingThreads)
    bgs_ring_kernel(const V* __restrict__ vals, const I* __restrict__ cols,
                    const float* __restrict__ b, float* x, float* scratch,
                    const int* __restrict__ picks, int width, int n, int k, int steps, int block,
                    float beta, int warps, int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kRingStages;
  float* xs = reinterpret_cast<float*>(smem + 16 * kRingStages);
  const size_t xb = kShared ? ((size_t)n * sizeof(float) + 15) & ~(size_t)15 : 0;
  unsigned char* ring = smem + 16 * kRingStages + xb;
  const size_t vregion = ring_region(tile_rows, width, sizeof(V));
  const size_t bregion = vregion + ring_region(tile_rows, width, sizeof(I));
  const size_t sbytes = ring_stage_bytes<V, I>(tile_rows, width);
  const int c = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(smem_u32(&full[s]), 32);
      mbar_init(smem_u32(&empty[s]), warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kShared) {
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) xs[row] = x[(size_t)row * k + c];
  }
  __syncthreads();
  float* xc = kShared ? xs : x + c;
  if (warp == warps)
    ring_produce(vals, cols, b, k, c, picks, steps, width, block, tile_rows, ring, vregion,
                 bregion, sbytes, full, empty, lane);
  else
    ring_consume<kLanes, kShared, V, I>(xc, scratch ? scratch + (size_t)c * block : nullptr, k,
                                        picks, steps, width, block, tile_rows, warps, beta,
                                        ring, vregion, bregion, sbytes, full, empty, warp, lane);
  if constexpr (kShared) {
    __syncthreads();
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) x[(size_t)row * k + c] = xs[row];
  }
}

constexpr int kRkDepth = 32;          // picks whose windows are fetched ahead
static_assert(32 % kRkDepth == 0, "the ring depth divides the 32 ids a warp loads");
constexpr int kRkSlots = 1;           // window slots a lane holds per pick
constexpr int kRkSharedThreads = 256; // CTA of the shared-memory path

// The lane's first kRkSlots slots of a pick's row window: what an RK step
// gathers and scatters through, fetched kRkDepth picks ahead.
struct RkWindow {
  float v[kRkSlots];
  int col[kRkSlots];
};

template <typename V, typename I>
__device__ __forceinline__ void rk_fetch(RkWindow& w, int r, const V* __restrict__ vals,
                                         const I* __restrict__ cols, int width, int lane) {
  const size_t base = (size_t)r * width;
#pragma unroll
  for (int q = 0; q < kRkSlots; ++q) {
    const int s = lane + 32 * q;
    w.v[q] = s < width ? to_f32(vals[base + s]) : 0.f;
    w.col[q] = s < width ? (int)cols[base + s] : 0;
  }
}

// The scatter of the slots from 32 * kRkSlots on (out of line, as
// window_tail): x (and d) are read again here, in the same slot order.
template <bool kShared, bool kDelta, typename V, typename I>
__device__ __noinline__ void rk_tail_scatter(float* xc, float* dc, int k, int r,
                                             const V* __restrict__ vals,
                                             const I* __restrict__ cols, int width, float beta,
                                             float g, int lane) {
  const size_t base = (size_t)r * width;
  for (int s = lane + 32 * kRkSlots; s < width; s += 32) {
    const float v = to_f32(vals[base + s]);
    if (v != 0.f) {
      const int j = (int)cols[base + s];
      const float contrib = __fmul_rn(__fmul_rn(beta, v), g);
      if constexpr (kDelta) {
        float& dj = x_at<kShared>(dc, j, k);
        dj = __fadd_rn(dj, contrib);
      }
      float& xj = x_at<kShared>(xc, j, k);
      xj = __fadd_rn(xj, contrib);
    }
  }
}

// One RK step of pick r on column xc (and dc), with b[r, c] and rn[r]:
// the dependent chain.  Padding slots (s >= width: value 0, column 0) read
// row 0 and add exact zeros to the dot, as the plain version's padded
// window does; the scatter skips them.
template <bool kShared, bool kDelta, typename V, typename I>
__device__ __forceinline__ void rk_step(float* xc, float* dc, int k, const RkWindow& w, int r,
                                        float br, float rnr, const V* __restrict__ vals,
                                        const I* __restrict__ cols, int width, float beta,
                                        int lane) {
  float xg[kRkSlots], dg[kRkSlots];
#pragma unroll
  for (int q = 0; q < kRkSlots; ++q) {
    if constexpr (kDelta) dg[q] = x_at<kShared>(dc, w.col[q], k);
    xg[q] = x_at<kShared>(xc, w.col[q], k);
  }
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kRkSlots; ++q)
    if (lane + 32 * q < width) acc = fmaf(w.v[q], xg[q], acc);
  if (width > 32 * kRkSlots)
    acc = window_tail<32 * kRkSlots, kShared>(xc, k, r, vals, cols, width, lane, acc);
  // At most 16 slots (the main path's rows): lanes 16-31 hold exact zeros,
  // which the butterfly's first level would add (v + 0 is v, up to the
  // sign of a zero), so it is skipped and lanes 0-15 get the sum one
  // shuffle level sooner (4% off a main-path chunk, PERF.md).  Lanes
  // 16-31 then hold no slot, so no scatter reads their g.
  float dot = acc;
  if (width > 16) dot += __shfl_xor_sync(kFull, dot, 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
  const float g = __fdiv_rn(__fsub_rn(br, dot), rnr);
#pragma unroll
  for (int q = 0; q < kRkSlots; ++q) {
    if (w.v[q] != 0.f) {
      const float contrib = __fmul_rn(__fmul_rn(beta, w.v[q]), g);
      x_at<kShared>(xc, w.col[q], k) = __fadd_rn(xg[q], contrib);
      if constexpr (kDelta) x_at<kShared>(dc, w.col[q], k) = __fadd_rn(dg[q], contrib);
    }
  }
  if (width > 32 * kRkSlots)
    rk_tail_scatter<kShared, kDelta>(xc, dc, k, r, vals, cols, width, beta, g, lane);
  __syncwarp();
}

// The whole sweep of one warp on its column c, unrolled by the ring depth
// and no further (as gs_warp_sweep).  Lane l holds the ids of picks s0 + l
// (ids) and s0 + 32 + l (next), and b[r, c] and rn[r] of the batch's picks
// (bq, rq; a step takes its own by shuffle): a batch's ids are loaded two
// batches ahead and its b and rn one batch ahead, so no step waits on a
// load that does not depend on x.
template <bool kShared, bool kDelta, typename V, typename I>
__device__ __forceinline__ void rk_warp_sweep(float* xc, float* dc, int k, int c,
                                              const V* __restrict__ vals,
                                              const I* __restrict__ cols,
                                              const float* __restrict__ b,
                                              const float* __restrict__ rn,
                                              const int* __restrict__ picks, int width, int steps,
                                              float beta, int lane) {
  RkWindow ring[kRkDepth];
  // Past the last step the ids are 0: row 0 exists whenever there is a step.
  int ids = lane < steps ? picks[lane] : 0;
  int next = 32 + lane < steps ? picks[32 + lane] : 0;
  float bq = b[(size_t)ids * k + c], rq = rn[ids];
#pragma unroll
  for (int u = 0; u < kRkDepth; ++u)
    rk_fetch(ring[u], __shfl_sync(kFull, ids, u), vals, cols, width, lane);
  for (int s0 = 0; s0 < steps; s0 += 32) {
    const int after = s0 + 64 + lane < steps ? picks[s0 + 64 + lane] : 0;
    const float bn = b[(size_t)next * k + c], rnn = rn[next];
#pragma unroll 1
    for (int g = 0; g < 32; g += kRkDepth) {
#pragma unroll
      for (int j = 0; j < kRkDepth; ++j) {
        const int u = g + j;
        if (s0 + u >= steps) return;  // warp-uniform: the last step is done
        rk_step<kShared, kDelta>(xc, dc, k, ring[j], __shfl_sync(kFull, ids, u),
                                 __shfl_sync(kFull, bq, u), __shfl_sync(kFull, rq, u), vals,
                                 cols, width, beta, lane);
        const int t = u + kRkDepth;  // the step whose window refills this slot
        const int r = __shfl_sync(kFull, t < 32 ? ids : next, t & 31);
        if (s0 + t < steps) rk_fetch(ring[j], r, vals, cols, width, lane);
      }
    }
    ids = next;
    next = after;
    bq = bn;
    rq = rnn;
  }
}

// kDelta: also add every contribution to the delta carry d (which no step
// reads); without it d is not touched.  kShared: the shared-memory path,
// one column a CTA (blockDim kRkSharedThreads: all of them copy, warp 0
// sweeps); otherwise the global path, kColsPerBlock columns a CTA.
template <typename V, typename I, bool kDelta, bool kShared>
__global__ void __launch_bounds__(kRkSharedThreads)
    rk_kernel(const V* __restrict__ vals, const I* __restrict__ cols, const float* __restrict__ b,
              const float* __restrict__ rn, float* x, float* d, const int* __restrict__ picks,
              int width, int n, int k, int steps, float beta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kShared) {
    extern __shared__ float xs[];
    float* ds = xs + n;  // the d column, with kDelta
    const int c = blockIdx.x;
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) {
      xs[row] = x[(size_t)row * k + c];
      if constexpr (kDelta) ds[row] = d[(size_t)row * k + c];
    }
    __syncthreads();
    if (warp == 0)
      rk_warp_sweep<true, kDelta>(xs, ds, k, c, vals, cols, b, rn, picks, width, steps, beta,
                                  lane);
    __syncthreads();
#pragma unroll 4
    for (int row = threadIdx.x; row < n; row += blockDim.x) {
      x[(size_t)row * k + c] = xs[row];
      if constexpr (kDelta) d[(size_t)row * k + c] = ds[row];
    }
  } else {
    const int c = blockIdx.x * kColsPerBlock + warp;
    if (c >= k) return;  // warp-uniform
    rk_warp_sweep<false, kDelta>(x + c, kDelta ? d + c : nullptr, k, c, vals, cols, b, rn, picks,
                                 width, steps, beta, lane);
  }
}

inline dim3 grid_for(int k) { return dim3((k + kColsPerBlock - 1) / kColsPerBlock); }

template <typename V, typename I>
int launch_gs(const void* vals, const void* cols, const void* b, void* x, const void* picks,
              int width, int n, int k, int steps, int limit, int write_base, float beta,
              int shared, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  launch_check(picks, steps, limit, s);
  if (shared) {
    const size_t bytes = sizeof(float) * (size_t)n;
    const cudaError_t err = cudaFuncSetAttribute(
        gs_kernel<V, I, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    gs_kernel<V, I, true><<<k, kGsSharedThreads, bytes, s>>>(
        (const V*)vals, (const I*)cols, (const float*)b, (float*)x, (const int*)picks, width, n,
        k, steps, write_base, beta);
  } else {
    gs_kernel<V, I, false><<<grid_for(k), 32 * kColsPerBlock, 0, s>>>(
        (const V*)vals, (const I*)cols, (const float*)b, (float*)x, (const int*)picks, width, n,
        k, steps, write_base, beta);
  }
  return (int)cudaGetLastError();
}

template <typename V, typename I, int kLanes, bool kShared>
int launch_ring(const void* vals, const void* cols, const void* b, void* x, void* scratch,
                const void* picks, int width, int n, int k, int steps, int block, float beta,
                int warps, int tile_rows, cudaStream_t s) {
  const size_t bytes = ring_smem_bytes<V, I>(n, width, tile_rows, kShared);
  const cudaError_t err =
      cudaFuncSetAttribute(bgs_ring_kernel<V, I, kLanes, kShared>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  bgs_ring_kernel<V, I, kLanes, kShared><<<k, 32 * (warps + 1), bytes, s>>>(
      (const V*)vals, (const I*)cols, (const float*)b, (float*)x, (float*)scratch,
      (const int*)picks, width, n, k, steps, block, beta, warps, tile_rows);
  return (int)cudaGetLastError();
}

template <typename V, typename I, bool kShared>
int launch_ring_lanes(int lanes, const void* vals, const void* cols, const void* b, void* x,
                      void* scratch, const void* picks, int width, int n, int k, int steps,
                      int block, float beta, int warps, int tile_rows, cudaStream_t s) {
  switch (lanes) {
    case 1:
      return launch_ring<V, I, 1, kShared>(vals, cols, b, x, scratch, picks, width, n, k, steps,
                                           block, beta, warps, tile_rows, s);
    case 2:
      return launch_ring<V, I, 2, kShared>(vals, cols, b, x, scratch, picks, width, n, k, steps,
                                           block, beta, warps, tile_rows, s);
    case 4:
      return launch_ring<V, I, 4, kShared>(vals, cols, b, x, scratch, picks, width, n, k, steps,
                                           block, beta, warps, tile_rows, s);
    default:
      return launch_ring<V, I, 32, kShared>(vals, cols, b, x, scratch, picks, width, n, k, steps,
                                            block, beta, warps, tile_rows, s);
  }
}

// tile_rows 0: the first design (bgs_kernel); otherwise the ring design
// with its plan (kernels/sweep_csr.py::block_plan), checked here.
template <typename V, typename I>
int launch_block_gs(const void* vals, const void* cols, const void* b, void* x, void* scratch,
                    const void* picks, int width, int n, int k, int steps, int limit, int block,
                    float beta, int shared, int lanes, int warps, int tile_rows, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile_rows > 0) {
    const bool ok = (lanes == 1 || lanes == 2 || lanes == 4 || lanes == 32) && warps >= 1 &&
                    warps <= kRingWarps &&
                    tile_rows <= warps * (32 / lanes) &&
                    (tile_rows >= block || scratch != nullptr) &&
                    ((uintptr_t)vals & 15) == 0 && ((uintptr_t)cols & 15) == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  launch_check(picks, steps, limit, s);
  if (tile_rows > 0) {
    return shared ? launch_ring_lanes<V, I, true>(lanes, vals, cols, b, x, scratch, picks, width,
                                                  n, k, steps, block, beta, warps, tile_rows, s)
                  : launch_ring_lanes<V, I, false>(lanes, vals, cols, b, x, scratch, picks, width,
                                                   n, k, steps, block, beta, warps, tile_rows, s);
  }
  if (shared) {
    const size_t bytes = sizeof(float) * ((size_t)n + block);
    const cudaError_t err = cudaFuncSetAttribute(
        bgs_kernel<V, I, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    bgs_kernel<V, I, true><<<k, kBgsThreads, bytes, s>>>(
        (const V*)vals, (const I*)cols, (const float*)b, (float*)x, nullptr, (const int*)picks,
        width, n, k, steps, block, beta);
  } else {
    bgs_kernel<V, I, false><<<k, kBgsThreads, 0, s>>>(
        (const V*)vals, (const I*)cols, (const float*)b, (float*)x, (float*)scratch,
        (const int*)picks, width, n, k, steps, block, beta);
  }
  return (int)cudaGetLastError();
}

template <typename V, typename I, bool kDelta>
int launch_rk(const void* vals, const void* cols, const void* b, const void* rn, void* x,
              void* d, const void* picks, int width, int n, int k, int steps, int limit,
              float beta, int shared, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  launch_check(picks, steps, limit, s);
  if (shared) {
    const size_t bytes = sizeof(float) * (size_t)n * (kDelta ? 2 : 1);
    const cudaError_t err = cudaFuncSetAttribute(
        rk_kernel<V, I, kDelta, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    rk_kernel<V, I, kDelta, true><<<k, kRkSharedThreads, bytes, s>>>(
        (const V*)vals, (const I*)cols, (const float*)b, (const float*)rn, (float*)x, (float*)d,
        (const int*)picks, width, n, k, steps, beta);
  } else {
    rk_kernel<V, I, kDelta, false><<<grid_for(k), 32 * kColsPerBlock, 0, s>>>(
        (const V*)vals, (const I*)cols, (const float*)b, (const float*)rn, (float*)x, (float*)d,
        (const int*)picks, width, n, k, steps, beta);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// shared: nonzero for the shared-memory path, 0 for the global path.
#define GS_ENTRY(NAME, V, I)                                                                     \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, void* x,               \
                      const void* picks, int width, int n, int k, int steps, int limit,         \
                      int write_base, float beta, int shared, void* stream) {                   \
    return launch_gs<V, I>(vals, cols, b, x, picks, width, n, k, steps, limit, write_base, beta, \
                           shared, stream);                                                      \
  }

// scratch: (k, block) f32 gammas, for the first design's global path and
// for ring picks of several tiles (may be null otherwise).  lanes, warps,
// tile_rows: the plan of kernels/sweep_csr.py::block_plan (tile_rows 0:
// the first design).
#define BLOCK_GS_ENTRY(NAME, V, I)                                                               \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, void* x, void* scratch, \
                      const void* picks, int width, int n, int k, int steps, int limit,         \
                      int block, float beta, int shared, int lanes, int warps, int tile_rows,   \
                      void* stream) {                                                            \
    return launch_block_gs<V, I>(vals, cols, b, x, scratch, picks, width, n, k, steps, limit,   \
                                 block, beta, shared, lanes, warps, tile_rows, stream);          \
  }

#define RK_ENTRY(NAME, V, I)                                                                     \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, const void* rn, void* x, \
                      const void* picks, int width, int n, int k, int steps, int limit,         \
                      float beta, int shared, void* stream) {                                    \
    return launch_rk<V, I, false>(vals, cols, b, rn, x, nullptr, picks, width, n, k, steps,     \
                                  limit, beta, shared, stream);                                  \
  }

#define RK_DELTA_ENTRY(NAME, V, I)                                                               \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, const void* rn, void* x, \
                      void* d, const void* picks, int width, int n, int k, int steps, int limit, \
                      float beta, int shared, void* stream) {                                    \
    return launch_rk<V, I, true>(vals, cols, b, rn, x, d, picks, width, n, k, steps, limit,     \
                                 beta, shared, stream);                                          \
  }

// The opt-in shared memory one CTA may use on `device`, in bytes.
extern "C" int sweep_shared_capacity(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

GS_ENTRY(sweep_rows_gs_f32_i32, float, int32_t)
GS_ENTRY(sweep_rows_gs_bf16_i16, __nv_bfloat16, int16_t)
GS_ENTRY(sweep_rows_gs_bf16_i32, __nv_bfloat16, int32_t)
BLOCK_GS_ENTRY(sweep_rows_block_gs_f32_i32, float, int32_t)
BLOCK_GS_ENTRY(sweep_rows_block_gs_bf16_i16, __nv_bfloat16, int16_t)
BLOCK_GS_ENTRY(sweep_rows_block_gs_bf16_i32, __nv_bfloat16, int32_t)
RK_ENTRY(sweep_rows_rk_f32_i32, float, int32_t)
RK_ENTRY(sweep_rows_rk_bf16_i16, __nv_bfloat16, int16_t)
RK_ENTRY(sweep_rows_rk_bf16_i32, __nv_bfloat16, int32_t)
RK_DELTA_ENTRY(sweep_rows_rk_delta_f32_i32, float, int32_t)
RK_DELTA_ENTRY(sweep_rows_rk_delta_bf16_i16, __nv_bfloat16, int16_t)
RK_DELTA_ENTRY(sweep_rows_rk_delta_bf16_i32, __nv_bfloat16, int32_t)
