// Randomized dense block Gauss-Seidel sweep.
//
// Replaces the TPU kernel src/repro/kernels/block_gs.py::block_gs_sweep
// (one grid step per block id, x resident in VMEM, the picked (block, n)
// row panel of A streamed in and fed to the MXU).  Same arithmetic, per
// step s with B = blocks[s]:
//   g = b[B] - A[B, :] @ x          (f32 accumulation)
//   x[B] = x[B] + beta * g          (rounded as written: no contraction)
// Inputs: A (n, n) f32 or bf16 (widened at the FMA), b and x (n, k) f32,
// blocks (steps,) int32 in [0, n / block); x is updated in place.
//
// Order of operations (what every version of this kernel keeps, so the
// results are bitwise those of the first port): the n columns of A
// are cut into slices of kSlice = 256.  For each output (row r of B,
// column c) and slice, part = one fmaf chain from 0 over the slice's
// columns j in order; then sum = the parts added with __fadd_rn from +0 in
// slice order, and x = __fadd_rn(x, __fmul_rn(beta, __fsub_rn(b, sum))).
// Exact zeros may close a chain (a ragged slice's padding); they can turn
// a part of -0 into +0, which the fold from +0 cannot tell apart.  A value
// depends on its row and column only: not on k, the launch shape or the
// order in which units run, so two runs agree bitwise and column 0 at
// k = 51 is column 0 at k = 1.
//
// What bounds it.  Every step reads its whole (block, n) row panel of A:
// at the main path's size (n = 16384, block = 128, k = 51) 8 MiB and
// 2 * block * n * k = 214 MFLOP, so the f32 rate (no tensor cores: IEEE
// f32, not TF32, for the bits above) bounds a step at about 3.2 us and the
// panel bytes at about 2.5 us on an H100.  The steps form a serial chain:
// step s + 1 reads the rows step s wrote.  On the card (PERF.md §6) the
// products set the time: a step has only 3328 outputs an SM, so a thread
// holds a 4 x 4 tile with four warps busy (an 8 x 4 tile was no faster),
// and each FMA costs about 2 cycles of its SMSP, 1.5 even with no shared
// loads, whether one warp or two share the SMSP.
// The first port (two grid barriers a step, the panel staged through
// registers once per 16 columns of x) took 34.5 us a step.
//
// Design.  One cooperative launch runs the whole chain, one CTA an SM.
//  - Units.  A unit is (column tile of x, slice, row group of kRows = 32
//    rows of the block); CTA c owns units c, c + grid, ... (two at the
//    main size).  Each unit computes the parts of its slice for its rows
//    and columns at every step.  Its x tile (256 rows of x by up to
//    kMaxCols columns) lives in shared memory for the whole launch when
//    the CTA's tiles fit, and is reloaded only where a step wrote rows
//    inside its slice; otherwise it is loaded at each step.
//  - The panel stream.  A producer warp walks the block ids (known at
//    launch; the panels never depend on x) and copies each unit's panel
//    rows of its slice into a ring of shared-memory stages, one 1-D bulk
//    copy (cp.async.bulk, completion counted on the stage's mbarrier) a
//    row, rows 16 bytes apart beyond 256 values, so that the rows a
//    quarter warp reads sit on distinct banks.  bf16 stays bf16 there and
//    is widened at the FMA.
//  - Register tiles.  Each compute thread holds 4 rows x 4 columns of x:
//    per 4 columns of A, 4 loads of A and 4 of x feed 64 FMAs, each output
//    its own chain over j in order.
//  - Counters instead of grid barriers.  The compute warps write a unit's
//    parts to a ring of kDepth steps of scratch and hand them, through an
//    mbarrier, to a publisher warp, which fences them to the device and
//    counts the unit's arrival, so the compute warps never wait for their
//    stores.  Reducer warps (two a CTA, one output a lane) fold the parts
//    in slice order, write x[B] and count the step done.  Writers publish
//    with fence.acq_rel.gpu and an atomic; readers load the counters with
//    ld.acquire.gpu and x and the parts at L2 (__ldcg).
//  - Lookahead.  A unit's parts at step s read x only inside its slice,
//    which changed last at the latest earlier step that wrote rows there.
//    So a unit waits for step s - 1 to be done only when step s - 1 wrote
//    rows of its slice (and, for the ring, for step s - kDepth + 1); the
//    others run ahead on the same values, so the result does not move.
//    A CTA takes its untouched units of a step first.  The untouched and
//    the touched units count their arrivals apart, so a reducer folds the
//    slices before the touched ones while the touched units still work.
//  - Every spin is bounded (kHangNs) and ends in __trap(): a broken
//    protocol shows as a launch error, not as a hung card.
//
// Scratch (the caller allocates block_gs_scratch_floats floats and zeroes
// the first kHeader): the counters, one 128-byte line each, then the
// parts' ring (kDepth, slices, block, k).
//
// Each C entry first launches the pick check (common.cuh), then the sweep,
// on the caller's stream, and returns the first error of the attribute
// call, a bad plan (cudaErrorInvalidValue) or the launch.
#include "common.cuh"

namespace {

constexpr int kSlice = 256;        // columns of A per part: fixes the order
constexpr int kRows = 32;          // rows of the block a unit holds (fewer for a smaller block)
constexpr int kTile = 4;           // rows of a thread's register tile (by 4 columns of x)
constexpr int kMaxCols = 64;       // columns of x a unit holds
constexpr int kComputeWarps = 8;
constexpr int kCompute = kComputeWarps * 32;
constexpr int kReduceWarps = 2;
constexpr int kProducer = kComputeWarps;       // warp that streams the panels
constexpr int kPublisher = kComputeWarps + 1;  // warp that publishes the parts
constexpr int kThreads = kCompute + 64 + kReduceWarps * 32;  // + producer, publisher, reducers
constexpr int kDepth = 4;          // steps of parts in flight
constexpr int kHeader = 1024;      // floats of counters ahead of the parts
constexpr int kLine = 32;          // words between counters
constexpr int kMaxStages = 8;
constexpr int kHand = 4;          // hand-offs of written parts to the publisher
constexpr int kBarBytes = 256;    // mbarriers: the stages' full and empty, the hand-offs'
constexpr uint64_t kHangNs = 10ull * 1000 * 1000 * 1000;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// The launch plan; kernels/block_gs.py::plan mirrors it.
struct Plan {
  int slices, rows, groups, cols, ctiles, units, grid, per_cta, xbufs, stages, pitch;
  long long smem;
};

inline Plan make_plan(int n, int block, int k, int itemsize, int sms, int cap) {
  Plan p;
  p.slices = cdiv(n, kSlice);
  p.rows = round4(block) < kRows ? round4(block) : kRows;
  p.groups = cdiv(block, p.rows);
  p.cols = k < kMaxCols ? k : kMaxCols;
  p.ctiles = cdiv(k, p.cols);
  p.units = p.ctiles * p.slices * p.groups;
  p.grid = p.units < sms ? p.units : sms;
  p.per_cta = cdiv(p.units, p.grid);
  p.pitch = kSlice * itemsize + 16;
  const long long stage = (long long)p.rows * p.pitch;
  const long long xtile = (long long)kSlice * round4(p.cols) * 4;
  p.xbufs = kBarBytes + p.per_cta * xtile + 2 * stage <= cap ? p.per_cta : 1;
  const long long left = cap - kBarBytes - p.xbufs * xtile;
  p.stages = left < 0 ? 0 : (int)(left / stage < kMaxStages ? left / stage : kMaxStages);
  p.smem = kBarBytes + p.xbufs * xtile + p.stages * stage;
  return p;
}

struct Args {
  const void* A;
  const float* b;
  float* x;
  float* part;
  const int* blocks;
  int steps, n, block, k;
  float beta;
  Plan p;
  int bulk;  // rows of A are 16-byte aligned: staged by bulk copies
};

// ---- mbarriers, bulk copies and counters (PTX, sm_90)

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Traps once a wait has lasted kHangNs: no wait lasts more than a few
// steps' work unless the protocol is broken.
__device__ __forceinline__ void hang_check(uint64_t& t0) {
  if (t0 == 0)
    t0 = global_ns();
  else if (global_ns() - t0 > kHangNs)
    __trap();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint64_t t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    hang_check(t0);
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

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void wait_geq(const unsigned* p, unsigned v) {
  uint64_t t0 = 0;
  while (load_acquire(p) < v) hang_check(t0);
}

// Publish this thread's earlier writes (and, after a barrier, its CTA's or
// warp's) and count one on *p.
__device__ __forceinline__ void release_add(unsigned* p) {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
  atomicAdd(p, 1u);
}

// The compute warps only (named barrier 1).
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCompute) : "memory");
}

// 4 staged values of A from 4 aligned values, widened to f32.
__device__ __forceinline__ void load4(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&a)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  a[0] = lo.x, a[1] = lo.y, a[2] = hi.x, a[3] = hi.y;
}

__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16& v) { v = __float2bfloat16(0.f); }

// Does step block bi write rows of x inside slice sl?
__device__ __forceinline__ bool touches(int bi, int block, int sl) {
  const int lo = bi * block;
  return lo < (sl + 1) * kSlice && lo + block > sl * kSlice;
}

// A unit's place: column tile, slice, row group.
struct Unit {
  int ct, sl, rg;
};

__device__ __forceinline__ Unit unit_of(const Plan& P, int u) {
  const int per_tile = P.slices * P.groups;
  const int rem = u % per_tile;
  return {u / per_tile, rem / P.groups, rem % P.groups};
}

// The CTA's units at step s in the order producer and consumers both walk:
// those step s - 1 did not touch first.  f(i, unit, touched).
template <typename F>
__device__ __forceinline__ void for_each_unit(const Args& a, int mine, int prev, int s, F f) {
  const Plan& P = a.p;
  for (int pass = 0; pass < 2; ++pass)
    for (int i = 0; i < mine; ++i) {
      const Unit u = unit_of(P, blockIdx.x + i * gridDim.x);
      const bool t = s > 0 && touches(prev, a.block, u.sl);
      if ((int)t != pass) continue;
      f(i, u, t);
    }
}

// A unit's parts of one step: thread tile (rq, cq) sums rows rq + RQ * i
// (i < kTile) of the staged panel against columns 4 cq ... 4 cq + 3 of the x
// tile, each output one fmaf chain over j in order.
template <typename V>
__device__ __forceinline__ void unit_parts(const V* st, int pe, const float* X, int KTP, int RQ,
                                           int CQ, int w4, int rv, int kt, float* out, int k,
                                           int tid) {
  for (int tile = tid; tile < RQ * CQ; tile += kCompute) {
    const int rq = tile % RQ, cq = tile / RQ;
    const float* xc = X + cq * 4;
    const V* ar = st + (size_t)rq * pe;
    float acc[kTile][4];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 2
    for (int j = 0; j < w4; j += 4) {
      float xv[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 v = *reinterpret_cast<const float4*>(xc + (j + jj) * KTP);
        xv[jj][0] = v.x, xv[jj][1] = v.y, xv[jj][2] = v.z, xv[jj][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float av[4];
        load4(ar + (size_t)i * RQ * pe + j, av);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[jj], xv[jj][q], acc[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int r = rq + RQ * i;
      if (r < rv)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (cq * 4 + q < kt) out[(size_t)r * k + cq * 4 + q] = acc[i][q];
    }
  }
}

// Rows r0 ... r1 - 1 of a unit's x tile (KTP columns) from x (row stride
// k): values past the slice's w rows or the tile's kt columns are zeros.
// Each thread keeps kLoads loads in flight, its elements kCompute apart.
__device__ __forceinline__ void reload_x(float* X, const float* x, int k, int KTP, int r0, int r1,
                                         int w, int kt, int tid) {
  constexpr int kLoads = 32;
  const int dj = kCompute / KTP, dc = kCompute % KTP;
  int j = r0 + tid / KTP, c = tid % KTP;
  while (j < r1) {
    float v[kLoads];
    int at[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      at[q] = j < r1 ? j * KTP + c : -1;
      v[q] = j < r1 && j < w && c < kt ? __ldcg(x + (size_t)j * k + c) : 0.f;
      c += dc, j += dj;
      if (c >= KTP) c -= KTP, ++j;
    }
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      if (at[q] >= 0) X[at[q]] = v[q];
  }
}

// sum = sum + parts[sl] (sl = from ... to - 1, in order), 32 loads at once.
__device__ __forceinline__ float fold(const float* pp, size_t stride, int from, int to,
                                     float sum) {
  constexpr int kBatch = 32;
  for (int s0 = from; s0 < to; s0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) v[q] = s0 + q < to ? __ldcg(pp + (size_t)(s0 + q) * stride) : 0.f;
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (s0 + q < to) sum = __fadd_rn(sum, v[q]);
  }
  return sum;
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 1) block_gs_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& P = a.p;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* hand_full = empty + kMaxStages;  // a unit's parts are written
  uint64_t* hand_empty = hand_full + kHand;  // ... and published
  const int KTP = round4(P.cols);
  const size_t xtile = (size_t)kSlice * KTP;  // floats
  float* xs = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned char* ring = smem + kBarBytes + P.xbufs * xtile * sizeof(float);
  const size_t stage_bytes = (size_t)P.rows * P.pitch;
  const int pe = P.pitch / (int)sizeof(V);  // values a staged row
  // counters: done, then per ring slot the arrivals of untouched units and
  // of touched ones (units whose slice the previous step wrote)
  unsigned* done = reinterpret_cast<unsigned*>(a.part);
  unsigned* arr_free = done + kLine;
  unsigned* arr_touched = done + kLine * (1 + kDepth);
  float* parts = a.part + kHeader;
  const int n = a.n, block = a.block, k = a.k, O = block * k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mine = (P.units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // reducer warps that own outputs: one output a lane, as far as they go
  const int nrw = min((int)gridDim.x * kReduceWarps, (O + 31) / 32);
  const unsigned reducers = nrw;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kComputeWarps);
    }
    for (int i = 0; i < kHand; ++i) {
      mbar_init(&hand_full[i], kComputeWarps);
      mbar_init(&hand_empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < kComputeWarps) {
    // Compute warps: each unit's parts at each step, in the walk's order.
    const int tid = threadIdx.x;
    const int RQ = P.rows / kTile, CQ = KTP / 4;
    const bool resident = P.xbufs >= mine;
    int it = 0, prev = 0;
    for (int s = 0; s < a.steps; ++s) {
      for_each_unit(a, mine, prev, s, [&](int i, Unit u, bool t) {
        // step s - 1 wrote rows of this slice: wait for it; and the ring
        // slot of step s must be free (step s - kDepth folded)
        const int need = t ? s : s - kDepth + 1;
        if (tid == 0 && need > 0) wait_geq(done, reducers * (unsigned)need);
        compute_sync();
        const int j0 = u.sl * kSlice, w = min(kSlice, n - j0), w4 = round4(w);
        const int c0 = u.ct * P.cols, kt = min(P.cols, k - c0);
        float* X = xs + (resident ? i : 0) * xtile;
        int r0 = 0, r1 = 0;  // x tile rows to (re)load
        if (!resident || s == 0) {
          r1 = w4;
        } else if (t) {
          r0 = max(prev * block - j0, 0);
          r1 = min(prev * block + block - j0, w);
        }
        if (r1 > r0) {
          reload_x(X, a.x + (size_t)j0 * k + c0, k, KTP, r0, r1, w, kt, tid);
          compute_sync();
        }
        const int stage = it % P.stages;
        mbar_wait(&full[stage], (it / P.stages) & 1);
        const V* st = reinterpret_cast<const V*>(ring + stage * stage_bytes);
        const int rv = min(P.rows, block - u.rg * P.rows);  // valid rows
        float* out = parts + ((size_t)(s % kDepth) * P.slices + u.sl) * O +
                     (size_t)u.rg * P.rows * k + c0;
        unit_parts(st, pe, X, KTP, RQ, CQ, w4, rv, kt, out, k, tid);
        // hand the written parts to the publisher and go on
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty[stage]);
          const int h = it % kHand;
          if (it >= kHand) mbar_wait(&hand_empty[h], (it / kHand - 1) & 1);
          mbar_arrive(&hand_full[h]);
        }
        ++it;
      });
      prev = a.blocks[s];
    }
  } else if (warp == kPublisher) {
    // Publisher: once the compute warps have written a unit's parts, make
    // them visible at the device and count the unit's arrival, so that the
    // compute warps never wait for their stores to land.
    if (lane == 0) {
      int it = 0, prev = 0;
      for (int s = 0; s < a.steps; ++s) {
        for_each_unit(a, mine, prev, s, [&](int, Unit, bool t) {
          const int h = it % kHand;
          mbar_wait(&hand_full[h], (it / kHand) & 1);
          release_add((t ? arr_touched : arr_free) + kLine * (s % kDepth));
          mbar_arrive(&hand_empty[h]);
          ++it;
        });
        prev = a.blocks[s];
      }
    }
  } else if (warp == kProducer) {
    // Producer: the units' panel rows, in the compute warps' order.
    const V* A = static_cast<const V*>(a.A);
    int it = 0, prev = 0;
    for (int s = 0; s < a.steps; ++s) {
      const int bi = a.blocks[s];
      for_each_unit(a, mine, prev, s, [&](int, Unit u, bool) {
        const int stage = it % P.stages;
        if (it >= P.stages) mbar_wait(&empty[stage], (it / P.stages - 1) & 1);
        const int j0 = u.sl * kSlice, w = min(kSlice, n - j0), w4 = round4(w);
        const int rv = min(P.rows, block - u.rg * P.rows);
        const V* src = A + ((size_t)bi * block + (size_t)u.rg * P.rows) * n + j0;
        unsigned char* dst = ring + stage * stage_bytes;
        if (a.bulk) {
          if (lane == 0) mbar_expect_tx(&full[stage], (uint32_t)(rv * w * sizeof(V)));
          __syncwarp();
          for (int r = lane; r < rv; r += 32)
            bulk_copy(dst + (size_t)r * P.pitch, src + (size_t)r * n, w * sizeof(V), &full[stage]);
        } else {
          V* d = reinterpret_cast<V*>(dst);
          for (int e = lane; e < rv * w4; e += 32) {
            const int r = e / w4, j = e % w4;
            if (j < w)
              d[(size_t)r * pe + j] = src[(size_t)r * n + j];
            else
              zero(d[(size_t)r * pe + j]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[stage]);
        }
        ++it;
      });
      prev = bi;
    }
  } else {
    // Reducers: fold each step's parts in slice order and update x[B].
    // The slices before the touched ones are folded once the untouched
    // units have arrived, the rest once the touched units have too.
    const int rw = (int)blockIdx.x * kReduceWarps + warp - kPublisher - 1;
    if (rw >= nrw) return;
    const int per_slice = P.groups * P.ctiles;  // units a slice
    unsigned want_free[kDepth], want_touched[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) want_free[d] = want_touched[d] = 0;
    int prev = 0;
    for (int s = 0; s < a.steps; ++s) {
      const int slot = s % kDepth;
      int tlo = P.slices, thi = P.slices;  // touched slices [tlo, thi)
      if (s > 0) {
        tlo = prev * block / kSlice;
        thi = (prev * block + block - 1) / kSlice + 1;
      }
      const unsigned touched = (unsigned)((thi - tlo) * per_slice);
#pragma unroll
      for (int d = 0; d < kDepth; ++d)
        if (d == slot) want_free[d] += P.units - touched, want_touched[d] += touched;
      unsigned wf = 0, wt = 0;
#pragma unroll
      for (int d = 0; d < kDepth; ++d)
        if (d == slot) wf = want_free[d], wt = want_touched[d];
      const int bi = a.blocks[s];
      const float* pp = parts + (size_t)slot * P.slices * O;
      for (int o = rw * 32 + lane; o < O; o += nrw * 32) {
        wait_geq(arr_free + kLine * slot, wf);
        const size_t at = (size_t)bi * O + o;  // row bi * block + o / k, column o % k
        const float bv = a.b[at];
        float sum = fold(pp + o, O, 0, tlo, 0.f);
        wait_geq(arr_touched + kLine * slot, wt);
        const float xv = __ldcg(a.x + at);  // step s - 1 is done: the touched units waited
        sum = fold(pp + o, O, tlo, P.slices, sum);
        a.x[at] = __fadd_rn(xv, __fmul_rn(a.beta, __fsub_rn(bv, sum)));
      }
      __syncwarp();
      if (lane == 0) release_add(done);
      prev = bi;
    }
  }
}

inline cudaError_t device_limits(int& sms, int& cap) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err;
}

template <typename V>
int launch(const void* A, const void* b, void* x, void* part, const void* blocks, int steps,
           int limit, int n, int block, int k, float beta, cudaStream_t stream) {
  launch_check(blocks, steps, limit, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int sms = 0, cap = 0;
  if ((err = device_limits(sms, cap)) != cudaSuccess) return (int)err;
  Args a = {A, (const float*)b, (float*)x, (float*)part, (const int*)blocks, steps, n, block, k,
            beta, make_plan(n, block, k, (int)sizeof(V), sms, cap), 0};
  if (a.p.stages < 1 || a.p.grid < 1) return (int)cudaErrorInvalidValue;
  a.bulk = ((size_t)n * sizeof(V)) % 16 == 0 && (uintptr_t)A % 16 == 0;
  void (*kernel)(const Args) = block_gs_kernel<V>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)a.p.smem)) != cudaSuccess)
    return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)a.p.grid),
                                    dim3(kThreads), args, (size_t)a.p.smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Floats of the scratch the caller allocates: kHeader floats of counters
// (the caller zeroes them), then the parts' ring (kDepth, slices, block, k).
extern "C" long long block_gs_scratch_floats(int n, int block, int k) {
  return kHeader + (long long)kDepth * cdiv(n, kSlice) * block * k;
}

// The plan a launch takes on a card with sms SMs and cap bytes of opt-in
// shared memory a CTA, as 12 ints: slices, rows, groups, cols, ctiles,
// units, grid, per_cta, xbufs, stages, pitch, smem bytes.
extern "C" void block_gs_plan(int n, int block, int k, int itemsize, int sms, int cap, int* out) {
  const Plan p = make_plan(n, block, k, itemsize, sms, cap);
  const int v[12] = {p.slices, p.rows,    p.groups, p.cols,   p.ctiles, p.units,
                     p.grid,   p.per_cta, p.xbufs,  p.stages, p.pitch,  (int)p.smem};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
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
