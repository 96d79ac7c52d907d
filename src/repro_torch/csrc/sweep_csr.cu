// Fused sequential sweeps over padded sparse rows: coordinate Gauss-Seidel
// and Kaczmarz, the latter also on two carries, and block Gauss-Seidel over
// aligned panels of rows (its note is above bgs_kernel below).
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
// A row's dot is the GS step's: lane l adds the slots l, l + 32, ... in that
// order (fmaf from +0), then warp_sum, and the update is rounded the same
// way, so at block = 1 the sweep is bitwise sweep_rows_gs.
//
// The rows of one pick are independent, the picks a chain.  A CTA owns one
// RHS column: its kBgsWarps warps take groups of kBgsGroup rows of the
// pick (a group's loads are issued together, so their latencies overlap),
// stage each row's gamma, then after a barrier its threads add the staged
// gammas to the pick's rows, and a second barrier closes the pick.  The
// shared-memory path holds x[0:n, c] and the gammas (n + block floats) in
// dynamic shared memory; the global path keeps x in global memory and
// stages the gammas in a (k, block) scratch the launcher allocates, so any
// block runs.  Both run the same row dot and update, so they are bitwise
// equal, and a column never reads another column, so column 0 at k = 51
// is bitwise column 0 at k = 1.
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

template <typename V, typename I>
int launch_block_gs(const void* vals, const void* cols, const void* b, void* x, void* scratch,
                    const void* picks, int width, int n, int k, int steps, int limit, int block,
                    float beta, int shared, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  launch_check(picks, steps, limit, s);
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

// scratch: (k, block) f32 for the global path's gammas (unused, may be
// null, on the shared-memory path).
#define BLOCK_GS_ENTRY(NAME, V, I)                                                               \
  extern "C" int NAME(const void* vals, const void* cols, const void* b, void* x, void* scratch, \
                      const void* picks, int width, int n, int k, int steps, int limit,         \
                      int block, float beta, int shared, void* stream) {                        \
    return launch_block_gs<V, I>(vals, cols, b, x, scratch, picks, width, n, k, steps, limit,   \
                                 block, beta, shared, stream);                                   \
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
