#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and ``nvcc``.
It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes, drives
the main paths (``repro_torch.solve`` with a default schedule, one sweep
launch per record chunk): randomized Gauss-Seidel on
``random_sparse_spd(16384)`` through the CSR and the ELL formats, and on
``block_banded_spd(16384, block=128, bands=2)`` through the block-banded
format and through dense block Gauss-Seidel (``format="dense",
gs_block=128``), and block Gauss-Seidel on CSR (``format="csr",
gs_block=`` 8 and 128, f32 and bf16, its sweep kernel held to its plain
version, bitwise ``sweep_rows_gs`` at block 1 and across its two paths,
chained serving chunks bitwise the one-shot solve); randomized Kaczmarz on ``random_sparse_lsq(32768, 4096)``
through CSR.  It drives the CSR matvec seam (``CsrOp.matvec(variant=)``
for all four variants, ``matvec_segsum``), runs the autotuner CLI in a
child process and a CSR solve under the table it wrote.  It drives the
distributed engine (``solve`` with ``Schedule(rounds=, local_steps=)`` and
a process group; one local-phase launch per round and rank): Kaczmarz on
the LSQ problem (CSR) and the banded problem, and Gauss-Seidel under
every strategy (``sparse_gs`` on the SPD problem in CSR and ELL,
``banded_gs``, ``halo_gs`` and ``dense_gs`` at ``gs_block=128`` on the
banded problem) at P = 1 in this process, and at P = 4 in four spawned
processes that share the card through a gloo group (``sparse_gs`` by
``sync="auto"``, and under the neighbor exchange and the all-gather on
``laplacian_spd(128)``, bitwise equal; ``halo_gs`` bitwise
``banded_gs``).  It drives the rest of the distributed engine: at P = 1
``dense_rk`` on ``random_lsq(32768, 4096)`` (its local phase's kernel
first held to the plain version at the dense window shape), ``sparse_rk``
under ``compress``, ``overlap`` on ``sparse_gs``, ``halo_gs`` and
``sparse_rk``, and ``partition="balanced"``; at P = 4 the Kaczmarz a2a
exchange bitwise the psum on the banded problem in CSR, ``sync="auto"``
on the LSQ design, ``dense_rk``, the overlapped syncs with their lag
traces, ``dense_gs``'s warned lockstep fallback, both codecs on
``sparse_rk`` and ``halo_gs``, and the balanced partition of a
norm-skewed design.  It drives the serving path
(``repro_torch.serve.SolverService`` over the CSR GS and RK problems,
``solve_batched`` and ``sequential_chunk``: tenants batched onto one
launch per chunk, padded columns bitwise their solo solves, early exits,
deadlines, streamed partials, an open-loop load batched and serial, and
``python -m repro_torch.launch.serve`` in a child process), the
sequential and distributed passes of ``launch.solve`` and ``launch.lsq``
(in process and as children: ``launch.lsq --workers 4`` dense, and on
CSR with a2a, overlap and the int8 wire) and times a
served chunk from Python, from a CUDA graph and with the host's per-chunk
reads.  It drives the paper's figure and theorem drivers
(``repro_torch.paper``: ``theory_validation``, ``fig1_residual`` and
``fig3_async_penalty`` at the reference's defaults, ``fig2_scaling`` on 1,
2, 4 and 8 gloo ranks) and both examples (``repro_torch.examples``),
replays the card's fig3 and fig2 streams on the CPU against the card's
residuals, and times one CSR GS and one CSR RK sweep with its record from a CUDA graph
against ``repro_torch.roofline.sweep_roofline``.  It holds the two paths of the GS and of both
Kaczmarz sweeps (the iterate in shared memory, or in global memory when it
is too tall) against the plain version and against each other (the
Kaczmarz sweeps also on rows wider than the main path's), the two banded
sweeps likewise (the window in shared or in global memory, at ragged
blocks and block 256 beside the main path's 128), the dense block-GS
sweep at blocks 2 to 256, ragged and unaligned n, two column tiles of x,
x tiles reloaded at each step and the lookahead's worst pick streams, the
column sums of the
records against theirs, the block-banded matvec at ragged shapes and at
both column-tile widths, and the two row-window matvecs (CSR sliced and
ELL) at k = 1 to 70 on ragged operators, with the operators' per-row
counts bitwise equal to without them, and the two segment sums there and
on layouts whose panel 0 ends in padding, is filled exactly or is
empty.  It holds the CSR operators built on the card to the CPU's
build of the same matrices, array for array.  It runs each CSR solve
three times and prints the median wall time with its spread.  It solves
column 0 of each path alone and holds it bitwise to column 0 of the
k = 51 solve.  It
checks what comes out, shows from the
launch counters (set to 0 just before each path and read just after) that
each path ran its kernels and nothing else, and times each kernel beside
its plain version, its roofline bound (``repro_torch.roofline``, with
the bytes and operations it reads) and, where one exists, a PyTorch
library call computing the same function, launched from Python and
replayed from a CUDA graph.

The last lines of standard output are the card's name and power limit (as
``nvidia-smi`` gives them), one JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.  Any failed check ends the run with a
non-zero exit code and no result.  Without a CUDA device, or without the
rest of the repository beside it, the script fails at once.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
SEED = 0
K = 51                      # the paper's right-hand-side count
SPD_N, SPD_ROW_NNZ, GS_SWEEPS = 16384, 16, 10
LSQ_M, LSQ_N, LSQ_ROW_NNZ, RK_SWEEPS = 32768, 4096, 16, 3
ELL_SWEEPS = 10             # ELL GS on the same SPD problem as CSR GS
BLOCK, BANDS, BANDED_SWEEPS = 128, 2, 10    # block_banded_spd(SPD_N, ...)
DENSE_SWEEPS = 10           # dense block GS (gs_block=BLOCK), same problem
PREFIX = 2048               # picks of the kernel-vs-plain sweep checks
SWEEP_RTOL = 1e-5           # rel ||x_kernel - x_plain|| / ||x_plain||
SPMV_RTOL, SPMV_ATOL = 1e-5, 1e-6   # |y_k - y_p| <= rtol * (|A| |x|) + atol
# bbmv sums 5 * 128 = 640 products per output; fmaf (kernel) against
# separately rounded products and sums (plain version) drift apart like a
# random walk of ~sqrt(640) * 2^-24 ~ 1.5e-6 relative to |A| |x|.
BBMV_RTOL, BBMV_ATOL = 2e-5, 1e-6
# The GS sweep's global-memory path: synthetic row windows over an iterate
# too tall for shared memory (kernels/sweep_csr.py::fits_shared).
GS_GLOBAL_N, GS_GLOBAL_WIDTH, GS_GLOBAL_K = 131072, 51, 4
# The RK sweeps' global-memory path: synthetic row windows over an iterate
# too tall for shared memory at one carry and at two
# (kernels/sweep_csr.py::fits_shared).
RK_GLOBAL_M, RK_GLOBAL_N, RK_GLOBAL_WIDTH, RK_GLOBAL_K = 32768, 65536, 16, 4
# The RK step's parts that the main path's 16-slot rows never reach: the
# butterfly's first level (width > 16), the out-of-line tails past 32
# slots (window_tail, rk_tail_scatter) and their padding slots, on
# synthetic ragged windows of these widths over the main path's n = LSQ_N,
# on both paths (csrc/sweep_csr.cu).
RK_WIDE_M, RK_WIDE_WIDTHS, RK_WIDE_K = 8192, (24, 51), 4
# The column sums of the records: |kernel - plain| <= COLSUM_RTOL * sum |t|
# per column.  Two orders of one f32 sum: were each a single chain of n
# adds, their roundings would drift like a random walk of sqrt(n) * 2^-24
# ~ 1.1e-5 relative at n = 32768; both add in short runs and a tree.
COLSUM_RTOL = 2e-5
COLSUM_SHAPES = ((SPD_N, K), (LSQ_M, K), (1000, 3), (1, 1))
# bbmv at ragged shapes: block 20 is not a multiple of the kernel's 64-row
# warp tile (its tile rows are still 16-byte aligned); block 18 rows are
# not, so its tiles and x are staged element by element.
RAGGED_NB, RAGGED_BLOCKS, RAGGED_KS = 9, (20, 18), (1, 3, 51)
# The banded sweeps beyond the main path's block 128: the ragged blocks
# (f32 rows of block 18 and bf16 rows of block 20 are staged element by
# element; block 20 f32 and the rest by bulk copies) and the largest block
# the wrappers take, at these bands, on both paths (csrc/banded_gs.cu),
# 2 * RAGGED_NB picks each.  Then more bands than the kernel's 15
# consumer warps: at 12 bands (25 tiles a block row) ten warps own two
# bands each and keep the second's Kaczmarz sums in shared memory; block
# 256 leaves room for stages of 8 tile rows at 7 bands and of 4 (the
# smallest stage) at 12 in f32; block 18 stages element by element.
BANDED_WIDE_BANDS = (1, 2)
BANDED_MANY_BANDS = ((256, (7, 12)), (18, (12,)))
BANDED_MANY_BANDS_KS = (3, 1)
# The dense block-GS sweep beyond the main chunk (csrc/block_gs.cu; slices
# of 256 columns of A, units of 32 rows, column tiles of 64): (n, block,
# pick stream, ks, the path a case must reach).  Random streams take
# 2 * n / block picks; at block 128 a stream repeats one block and one
# alternates the two blocks of one slice (every step writes the slice the
# next one reads: the lookahead's worst cases), at n = 2048 (one unit a
# CTA) and at n = 16384 (two).  Blocks 64, 96 (a block across a slice
# edge), 256 and 20 at n = 3000 (the last slice ragged); k = 70 and 128
# (two column tiles, the second ragged at 70); n = 3002 (rows of A that
# are no multiple of 16 bytes, staged element by element); block 256 at
# n = 16384 (four units a CTA, whose x tiles do not all fit: reloaded at
# each step); block 1 (coordinate GS: the dense distributed pass of
# launch.solve at its default gs_block); a stream of one rank's quarter
# of the blocks at n = 16384 (dense_gs at P = 4: its picks touch a quarter
# of the units).  f32 and bf16 A.
BGS_CASES = (
    (2048, 64, "random", (51, 3, 1), None),
    (2048, 96, "random", (51, 3, 1), None),
    (2048, 256, "random", (51, 3, 1), None),
    (3000, 20, "random", (51, 3, 1), None),
    (2048, 128, "repeat", (51, 3, 1), None),
    (2048, 128, "alternate", (51, 3, 1), None),
    (2048, 96, "random", (70, 1), "two column tiles"),
    (2048, 64, "random", (128, 1), "two column tiles"),
    (3002, 19, "random", (51, 3, 1), "element-by-element staging"),
    (3002, 2, "random", (3, 1), "element-by-element staging"),
    (16384, 256, "random", (51, 1), "x tiles reloaded"),
    (16384, 128, "repeat", (51, 1), "two units a CTA"),
    (16384, 128, "alternate", (51, 1), "two units a CTA"),
    (2048, 1, "random", (3, 1), None),
    (16384, 128, "slab", (51, 1), "two units a CTA"),
)
BGS_STREAM_STEPS = 40
# The two row-window matvecs (csrc/common.cuh rw_kernel: spmv_csr_sliced
# and spmv_ell) beyond the main path's k = 51: RW_KS columns (a warp spans
# one to 32 rows) on ragged operators of RW_M x RW_N (the last panel of 8
# not full) with rows of 0 to RW_WIDE and to RW_NARROW nonzeros,
# rows_per_panel 1 (empty rows are empty panels) and 8, f32/i32 and
# bf16/i16; ELL at its exact width, truncated to RW_NARROW, in bf16, and a
# slab of RW_SLAB rows of a square RW_M operator (n_cols != rows); each
# with the operator's per-row counts (the chains stopped after the first
# padding slot) and without.
RW_KS = (1, 3, 16, 31, 32, 33, 51, 64, 70)
RW_M, RW_N, RW_WIDE, RW_NARROW, RW_SLAB = 3001, 2500, 70, 24, 700
MONO_RTOL = 1e-6            # err_sq non-increasing up to this rounding
SOLVE_RUNS = 3              # runs of each CSR solve, for the wall times
RESID_RTOL = 1e-4           # kernel residual vs dense torch.matmul residual
# The distributed Kaczmarz engine.  P = 1 in this process: sparse_rk on the
# LSQ problem (CSR), DIST_RK_ROUNDS rounds of LSQ_M local steps; banded_rk
# on the banded problem, BANDED_RK_ROUNDS rounds of nb.  P = 4 in four
# processes sharing the card: rounds of P4_SPARSE_STEPS and
# P4_BANDED_STEPS picks per rank.  sparse_rk's four ranks each sweep their
# own slab and their deltas add up; with LSQ_M / 4 steps per rank and
# round the sum overshoots and the residual grows (a CPU rehearsal at the
# same m/n and row count per column diverged), so P = 4 runs 512 steps
# per rank and round, 4 sweeps in all.
DIST_RK_ROUNDS = 3
BANDED_RK_ROUNDS, BANDED_RK_BETA = 10, 0.9
P4 = 4
P4_SPARSE_ROUNDS, P4_SPARSE_STEPS, P4_SPARSE_BETA = 64, 512, 0.9
P4_BANDED_ROUNDS, P4_BANDED_STEPS = 60, 32
P4_FALL, P4_REL = 1e-2, 1e-2  # residual falls 100-fold; final rel < 1e-2
# The distributed GS engine.  P = 1 in this process at full width:
# sparse_gs on the SPD problem (CSR and ELL), DIST_GS_ROUNDS rounds of
# SPD_N local steps; banded_gs, halo_gs and dense_gs (gs_block BLOCK) on
# the banded problem, DIST_BANDED_GS_ROUNDS rounds of nb.  P = 4 in four
# processes sharing the card (seed P4_GS_SEED: banded_gs, halo_gs and
# dense_gs draw the same block picks, a2a and the all-gather the same
# rows): sparse_gs by sync="auto" on the SPD problem in CSR (its neighbor
# graph is dense, so a2a falls back to the all-gather),
# P4_SPARSE_GS_ROUNDS rounds of a slab's rows; a2a and the all-gather on
# laplacian_spd(FCG_SIDE) in CSR (each slab reads its neighbours': two
# rotations), P4_LAP_ROUNDS rounds; banded_gs, halo_gs and dense_gs,
# P4_BANDED_GS_ROUNDS rounds of a slab's block rows.  beta 1.  A CPU
# rehearsal at n = 2048, P = 4 fell 216-fold in 10 sparse rounds and
# 790-fold in 4 banded ones.
DIST_GS_ROUNDS, DIST_BANDED_GS_ROUNDS = 3, 10
P4_SPARSE_GS_ROUNDS, P4_LAP_ROUNDS, P4_BANDED_GS_ROUNDS = 16, 4, 12
P4_GS_SEED = SEED + 22
# The rest of the distributed engine.  P = 1 in this process
# (engine_rest_p1_phase): dense_rk on random_lsq(LSQ_M, LSQ_N, n_rhs=K)
# (512 MiB f32, the sparse RK design's shape), DENSE_RK_ROUNDS rounds of
# DENSE_RK_STEPS picks, one sweep_rows_rk_delta launch a round over the
# rows as windows of width LSQ_N (its kernel held to the plain version on
# DENSE_CHECK_PICKS picks, one in DENSE_CHECK_FOREIGN on the appended zero
# row); sparse_rk under compress, bitwise no compression; overlap on
# sparse_gs, halo_gs and sparse_rk, bitwise lockstep with lag 0;
# partition="balanced" on sparse_rk and sparse_gs (one slab: the identity
# permutation, bitwise contiguous).  P = 4 (p4_rank): the Kaczmarz a2a
# exchange and the psum on the banded problem in CSR (a chain of column
# slabs), P4_A2A_ROUNDS rounds of P4_A2A_STEPS; sync="auto" on the LSQ
# design (a dense graph: the psum, bitwise the psum run); dense_rk on the
# dense design, P4_DENSE_RK_ROUNDS rounds of P4_DENSE_RK_STEPS at the
# theory's beta~ for tau = steps - 1; overlap on sparse_gs (SPD, beta
# P4_OVERLAP_GS_BETA), halo_gs and sparse_rk, dense_gs's overlap the
# lockstep fallback; compress bf16 and int8_ef on sparse_rk and halo_gs;
# partition="balanced" on the LSQ design with its first quarter of rows
# scaled by P4_SKEW (norm-skewed).  Runs that must converge fall
# P4_CONVERGE-fold.
DENSE_RK_ROUNDS, DENSE_RK_STEPS = 2, 4096
DENSE_CHECK_PICKS, DENSE_CHECK_FOREIGN = 32, 8
DENSE_RK_SEED = SEED + 41
P4_A2A_ROUNDS, P4_A2A_STEPS = 16, 512
P4_DENSE_RK_ROUNDS, P4_DENSE_RK_STEPS = 8, 256
P4_OVERLAP_GS_BETA, P4_SKEW, P4_CONVERGE = 0.9, 20.0, 0.1
INT8_EF_RTOL = 5e-2         # the int8_ef iterate against the f32 wire's
# The serving phase (serving_phase): the main SPD problem served by GS and
# the main LSQ design by RK, both on CSR, in chunks of SERVE_REC picks, at
# most 32 sweeps (GS: rtol 1e-3 needs about 10-18 at lam in [0.79, 1.21])
# and 8 sweeps (RK) a batch; RK requests take b in A's range (the
# problem's own columns).  The open-loop load: SERVE_LOAD_REQUESTS at
# SERVE_LOAD_HZ, widths SERVE_LOAD_WIDTHS, batched (max_batch
# SERVE_MAX_BATCH, admission window SERVE_WINDOW_S) and serial.
SERVE_REC, SERVE_ITERS, SERVE_RK_ITERS = 4096, 32 * SPD_N, 8 * LSQ_M
SERVE_SEED, SERVE_RTOL, SERVE_LOOSE, SERVE_TIGHT = SEED + 31, 1e-3, 0.1, 2e-4
SERVE_RK_RTOL = 1e-2
SERVE_MAX_BATCH, SERVE_WINDOW_S, SERVE_TIMEOUT_S = 32, 0.002, 120.0
SERVE_CHAIN = 4             # chained chunks held against solve_sequential
SERVE_LOAD_REQUESTS, SERVE_LOAD_HZ, SERVE_LOAD_WIDTHS = 32, 200.0, (1, 2, 4)
SERVE_CLI_N, SERVE_CLI_REQUESTS = 4096, 16
# the launcher's cap and record: 32 sweeps of its n, a record a sweep
SERVE_CLI_ITERS, SERVE_CLI_REC = 32 * SERVE_CLI_N, SERVE_CLI_N
SERVE_TIME_REPS = 20
# The sequential CLIs, the bounded-delay simulator, the CG baselines and
# the theory (sequential_cli_phase).  In process at the main path's full
# width: launch.solve on random_sparse_spd(SPD_N, row_nnz=16) (its default
# row_nnz), GS_SWEEPS sweeps on CSR; launch.lsq on random_sparse_lsq(LSQ_M,
# LSQ_N) (noise 0.01, its default), CLI_LSQ_SWEEPS sweep on CSR, the async
# pass at tau CLI_TAU (32768 simulator steps on the densified design).
CLI_LSQ_SWEEPS, CLI_TAU = 1, 32
CLI_TIMEOUT_S = 300
# The simulator at fig3_async_penalty's size: random_sparse_spd(SIM_N,
# row_nnz=16, offdiag=0.95), SIM_SWEEPS sweeps, every tau of SIM_TAUS under
# the three consistent delay modes (beta 1: 2 rho tau < 1 at every tau) and
# inconsistent reads (beta_opt_inconsistent).  Consistent runs must cut
# err_sq SIM_FALL-fold (Thm 4.1), inconsistent ones SIM_INC_FALL-fold (a
# CPU run of the same size fell 20-fold at tau 64, beta 0.16).  The runs at
# SIM_CPU_TAU also run on the CPU on the same streams: x within SIM_RTOL
# (rel, norm) and the last err_sq within SIM_ERR_RTOL (rel; err_sq is a
# small difference of x and x*, 1e-5 of its start).  The RK simulator:
# random_lsq(SIM_RK_M, SIM_RK_N), SIM_RK_SWEEPS sweeps at tau SIM_RK_TAU.
SIM_N, SIM_SWEEPS, SIM_TAUS, SIM_K, SIM_CPU_TAU = 1024, 10, (4, 16, 64), 4, 16
SIM_FALL, SIM_INC_FALL, SIM_RTOL, SIM_ERR_RTOL = 1e-2, 1e-1, 1e-4, 1e-2
SIM_RK_M, SIM_RK_N, SIM_RK_K, SIM_RK_SWEEPS, SIM_RK_TAU = 4096, 512, 8, 1, 32
# Flexible CG on laplacian_spd(FCG_SIDE) (n = 16384, dense 1 GiB), its
# preconditioner FCG_SWEEPS block-GS sweeps of FCG_BLOCK rows (one
# block_gs_sweep launch an application), FCG_ITERS iterations against
# plain CG (the reference's tests/test_cg.py claims).
FCG_SIDE, FCG_BLOCK, FCG_SWEEPS, FCG_ITERS = 128, 128, 2, 12
# Block GS on CSR (csr_block_gs_phase): solve(format="csr", gs_block=B) on
# the main SPD problem, CSR_BGS_SWEEPS sweeps of SPD_N // B picks (one
# record a sweep) at each B of CSR_BGS_BLOCKS with f32 storage, and at the
# last B with bf16; SERVE_CHAIN serving chunks of a sweep each.  The
# kernel is held to its plain version on short streams at the blocks of
# CSR_BGS_CHECK (block: picks): 30 leaves warps and lanes without a row,
# 1000 (past the dense kernel's 256) leaves 384 rows in no panel and goes
# through the ring in tiles.  Beyond them: bf16/i16 at block
# 30 on odd panel ids only (bulk copies that start off 16-byte alignment),
# a stream that repeats each panel (a pick reads the rows the last one
# wrote), rows wider than 64 slots (random_sparse_spd(SPD_N,
# row_nnz=CSR_BGS_WIDE_NNZ)), rows too wide for the ring (CSR_BGS_NORING:
# n, width; the first design), and a main-path chunk on the global path.
CSR_BGS_BLOCKS, CSR_BGS_SWEEPS, CSR_BGS_SEED = (8, 128), 10, SEED + 51
CSR_BGS_CHECK = {8: 256, 30: 64, 128: 32, 1000: 4}
CSR_BGS_WIDE_NNZ, CSR_BGS_NORING = 40, (2048, 15000)
# Lanczos (64 iterations) against eigvalsh at SIM_N; rk_rho of the main
# LSQ design in f32 against the same function in f64 by row blocks.
LANCZOS_RTOL, RK_RHO_RTOL = 1e-3, 1e-4
# The paper's drivers and the two examples (paper_phase), each at the
# reference's defaults (fig3's 30 simulated solves of 10240 steps too);
# fig2 at n = PAPER_FIG2_N on PAPER_WORKERS gloo ranks sharing the card.
# Checks: fig3's consistent-read penalty at most PAPER_PENALTY_MAX at
# every tau (the reference's: 1.00-1.18x), fig2's residual at P = 1 at
# most PAPER_P1_RESID of ||b|| after its 10 rounds: a 50-fold fall, not
# 100-fold, because a stream that leaves a coordinate unpicked for 10
# sweeps (e^-10 a coordinate: about 4.5% of streams at n = 1024) stalls
# near 1e-2, and the card's seed-0 stream is one (1.248e-2; seeds 1-3
# reach 1.1e-3 to 1.8e-3).  The card's own streams replayed on the CPU
# (the same problem; fig3's at its largest tau, fig2's at P = 1): every
# residual within PAPER_REPLAY_RTOL of the card's, so a wrong kernel or
# simulator step fails whatever the streams' luck.  Then one CSR GS and
# one CSR RK sweep of the main path and its record, PAPER_GRAPH_CALLS a
# CUDA graph, against roofline.sweep_roofline.
PAPER_FIG2_N, PAPER_WORKERS = 1024, (1, 2, 4, 8)
PAPER_PENALTY_MAX, PAPER_P1_RESID, PAPER_REPLAY_RTOL = 1.5, 2e-2, 1e-4
PAPER_GRAPH_CALLS = 3
PAPER_DENSE_PICKS = 2048    # picks of the dense coordinate sweeps' timing


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def live_children() -> list[str]:
    """The ids of this process's living child processes (Linux /proc)."""
    tasks = Path(f"/proc/{os.getpid()}/task")
    return [pid for task in tasks.iterdir()
            for pid in (task / "children").read_text().split()]


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events,
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int):
    """Mean milliseconds of ``fn()`` replayed from one CUDA graph of
    ``calls`` calls: the card's time with the host's launch work taken out.
    One warm-up call on a side stream first.  Every kernel entry needs this
    time, so a capture that fails, or a launch that fails or faults under
    the graph, raises and fails the phase."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, 3) / calls
    del graph
    return ms


def bound_ms(work) -> tuple[float, str]:
    """The least ms this card takes for ``work`` (a ``roofline.Work``) and
    what bounds it: the card's published peaks in ``repro_torch.roofline``
    (a card without them raises)."""
    import torch

    from repro_torch import roofline
    return roofline.bound_ms(work, torch.cuda.get_device_name(0))


def work_keys(work) -> dict:
    """A kernel entry's ``bytes`` and ``flops``: the work its bound reads."""
    return dict(bytes=work.bytes, flops=work.flops)


def rel(a, b) -> float:
    return float((a - b).double().norm() / (b.double().norm() + 1e-300))


def p4_rank(group, device, path):
    """One rank of the P = 4 phase (run in a spawned process): rebuild the
    operators from the arrays the parent saved (CSR: the LSQ design, its
    norm-skewed copy, the SPD problem, the Laplacian; the band tiles, and
    the dense matrix and its CSR from them; the dense LSQ design), run the
    distributed Kaczmarz and GS strategies with the launch counters set to
    0 just before each, and gather every rank's counts, wall time and a
    SHA-256 of its returned x."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.core.distributed import solve_distributed
    from repro_torch.core.operators import CsrOp, DenseOp
    from repro_torch.kernels import ops
    data = torch.load(path)

    def csr(name):
        return convert.csr_from_arrays(
            *(data[f"{name}_{f}"].numpy() for f in (
                "data", "indices", "row_id", "row_start", "row_nnz")),
            device=device, **data[f"{name}_layout"])

    band = convert.banded_from_arrays(data["tiles"].numpy(), BANDS,
                                      device=device)
    band_dense = band.to_dense()
    spd_csr, lap_csr, lsq_csr = csr("spd"), csr("lap"), csr("lsq")
    nb4 = band.nb // dist.get_world_size(group)
    slab = data["spd_b"].shape[0] // dist.get_world_size(group)
    gs = dict(action="gs", seed=P4_GS_SEED)
    lsq_rk = dict(action="rk", seed=SEED + 21, rounds=P4_SPARSE_ROUNDS,
                  local_steps=P4_SPARSE_STEPS, beta=P4_SPARSE_BETA)
    band_rk = dict(action="rk", seed=SEED + 23, rounds=P4_A2A_ROUNDS,
                   local_steps=P4_A2A_STEPS, beta=P4_SPARSE_BETA)
    halo = dict(gs, sync="halo", rounds=P4_BANDED_GS_ROUNDS, local_steps=nb4)
    band_csr = CsrOp.from_dense(band_dense)
    runs = (
        ("sparse_rk", csr("lsq"), "lsq",
         dict(action="rk", sync="psum", seed=SEED + 21,
              rounds=P4_SPARSE_ROUNDS, local_steps=P4_SPARSE_STEPS,
              beta=P4_SPARSE_BETA)),
        ("banded_rk", band, "band",
         dict(action="rk", sync="psum", seed=SEED + 21,
              rounds=P4_BANDED_ROUNDS, local_steps=P4_BANDED_STEPS,
              beta=BANDED_RK_BETA)),
        ("sparse_gs", spd_csr, "spd",
         dict(gs, sync="auto", rounds=P4_SPARSE_GS_ROUNDS,
              local_steps=slab)),
        ("sparse_gs a2a", lap_csr, "lap",
         dict(gs, sync="a2a", rounds=P4_LAP_ROUNDS, local_steps=slab)),
        ("sparse_gs allgather", lap_csr, "lap",
         dict(gs, sync="allgather", rounds=P4_LAP_ROUNDS, local_steps=slab)),
        ("banded_gs", band, "band",
         dict(gs, sync="allgather", rounds=P4_BANDED_GS_ROUNDS,
              local_steps=nb4)),
        ("halo_gs", band, "band",
         dict(gs, sync="halo", rounds=P4_BANDED_GS_ROUNDS, local_steps=nb4)),
        ("dense_gs", DenseOp(band_dense), "band",
         dict(gs, sync="allgather", block=BLOCK, rounds=P4_BANDED_GS_ROUNDS,
              local_steps=nb4)),
        # the rest of the engine
        ("sparse_rk a2a", band_csr, "band", dict(band_rk, sync="a2a")),
        ("sparse_rk psum (banded CSR)", band_csr, "band",
         dict(band_rk, sync="psum")),
        ("sparse_rk auto", lsq_csr, "lsq", dict(lsq_rk, sync="auto")),
        ("dense_rk", DenseOp(data["dense_A"].to(device)), "dense",
         dict(action="rk", sync="psum", seed=DENSE_RK_SEED,
              rounds=P4_DENSE_RK_ROUNDS, local_steps=P4_DENSE_RK_STEPS,
              beta=float(data["dense_beta"]))),
        ("sparse_gs overlap", spd_csr, "spd",
         dict(gs, sync="auto", rounds=P4_SPARSE_GS_ROUNDS, local_steps=slab,
              beta=P4_OVERLAP_GS_BETA, overlap=True)),
        ("halo_gs overlap", band, "band", dict(halo, overlap=True)),
        ("sparse_rk overlap", lsq_csr, "lsq",
         dict(lsq_rk, sync="psum", overlap=True)),
        ("dense_gs overlap", DenseOp(band_dense), "band",
         dict(gs, sync="allgather", block=BLOCK, rounds=P4_BANDED_GS_ROUNDS,
              local_steps=nb4, overlap=True)),
        *((f"sparse_rk {c}", lsq_csr, "lsq",
           dict(lsq_rk, sync="psum", compress=c))
          for c in ("bf16", "int8_ef")),
        *((f"halo_gs {c}", band, "band", dict(halo, compress=c))
          for c in ("bf16", "int8_ef")),
        ("sparse_rk balanced", csr("skew"), "skew",
         dict(lsq_rk, sync="auto", partition="balanced")))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {}
    for tag, op, prob, kw in runs:
        b = data[f"{prob}_b"].to(device)
        xs = data[f"{prob}_x_star"].to(device)
        sync()
        dist.barrier(group)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = solve_distributed(op, b, torch.zeros((op.shape[1],
                                                        b.shape[1]),
                                                       device=device),
                                    xs, group=group, **kw)
        sync()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        digest = hashlib.sha256(res.x.cpu().numpy().tobytes()).hexdigest()
        ranks = [None] * dist.get_world_size(group)
        dist.all_gather_object(ranks, (counts, wall, digest), group=group)
        out[tag] = dict(x=res.x.cpu(), resid=res.resid.cpu(), tau=res.tau,
                        bytes_per_round=res.bytes_per_round, ranks=ranks,
                        lag=None if res.lag is None else res.lag.cpu(),
                        warned=[str(w.message) for w in caught])
    return out


def engine_rest_p1_phase(torch, ops, lsq, spd, banded, launches,
                         smi: str) -> dict:
    """The rest of the distributed engine at P = 1 in this process, on a
    world-size-1 gloo group: dense_rk at full width (its local phase's
    kernel first held to the plain version at the dense window shape),
    compress, overlap and partition="balanced", each with its launches
    counted exactly and added to ``launches``.  Returns the dense design,
    the theory's rho_rk of it, and the dense-window numbers of
    sweep_rows_rk_delta for the kernels' line."""
    import math

    from repro_torch import Schedule, random_lsq, roofline, solve, theory
    from repro_torch.kernels import ref, sweep_csr
    from repro_torch.launch.mesh import process_group

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()

    def counted(tag, expect, run):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        check(got == {name: expect.get(name, 0) for name in ops.KERNELS},
              f"{tag}: launched exactly {expect} ({wall:.4f} s wall on "
              f"{smi})")
        for name, n in got.items():
            launches[name] += n
        return out

    def bitwise(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("x", "err_sq", "resid"))

    def falls_and_matches(tag, prob, res):
        check(bool(torch.isfinite(res.x).all())
              and bool((res.resid[-1] < res.resid[0]).all()),
              f"{tag}: x finite, the residual falls (column 0 "
              + ", ".join(f"{v:.4g}" for v in res.resid[:, 0].tolist())
              + ")")
        want = torch.linalg.vector_norm(prob.b - prob.A @ res.x, dim=0)
        e = float(((res.resid[-1] - want).abs() / want).max())
        check(e <= RESID_RTOL, f"{tag}: the last record is the residual of "
              f"the returned x in the original system (dense torch.matmul), "
              f"max rel diff {e:.3e} <= {RESID_RTOL:g}")

    t0 = time.perf_counter()
    dense = random_lsq(LSQ_M, LSQ_N, n_rhs=K, seed=SEED)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    rho = float(theory.rk_rho(dense.A))
    torch.cuda.synchronize()
    print(f"  random_lsq({LSQ_M}, {LSQ_N}, n_rhs={K}) on the card: "
          f"{t_build:.2f} s; rk_rho {rho:.4f} ({time.perf_counter() - t0:.2f}"
          " s)", flush=True)

    # dense_rk's local phase at its main-path shape: the rows as windows
    # of width n, column ids arange(n), one all-zero row (b 0, rn 1) that
    # the picks a rank does not own land on.
    m, n = dense.A.shape
    vals = torch.cat([dense.A, dense.A.new_zeros((1, n))])
    cols = torch.arange(n, dtype=torch.int32, device=dev).expand(
        m + 1, n).contiguous()
    rn = (dense.A * dense.A).sum(1)
    rn_z = torch.cat([torch.where(rn > 0, rn, 1.0), rn.new_ones((1,))])
    b_z = torch.cat([dense.b, dense.b.new_zeros((1, K))])
    gen = torch.Generator(dev).manual_seed(SEED + 42)
    x = torch.randn((n, K), generator=gen, device=dev)
    d = torch.randn((n, K), generator=gen, device=dev)
    picks = torch.randint(0, m, (DENSE_CHECK_PICKS,), generator=gen,
                          device=dev)
    picks[::DENSE_CHECK_FOREIGN] = m
    args = (vals, cols, b_z, rn_z)
    got = ops.sweep_rows_rk_delta(*args, x, d, picks, beta=0.9)
    want = ref.sweep_rows_rk_delta_ref(*args, x, d, picks, beta=0.9)
    e = max(rel(got[0], want[0]), rel(got[1], want[1]))
    check(e <= SWEEP_RTOL, f"sweep_rows_rk_delta at dense_rk's window "
          f"shape ({m + 1}x{n} rows of width {n}, k={K}, "
          f"{DENSE_CHECK_PICKS} picks, every {DENSE_CHECK_FOREIGN}th on the "
          f"zero row): rel err of x and d {e:.3e} <= {SWEEP_RTOL:g}")
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    p32 = picks.to(torch.int32)
    glob = sweep_csr.sweep_rows_rk_delta(*args, x, d, p32, beta=0.9,
                                         limit=m + 1, _shared=False)
    check(torch.equal(glob[0], got[0]) and torch.equal(glob[1], got[1]),
          "sweep_rows_rk_delta at the dense window: the global path bitwise "
          "the shared-memory path")
    foreign = torch.full((64,), m, device=dev)
    zx, zd = ops.sweep_rows_rk_delta(*args, x, d, foreign, beta=0.9)
    check(torch.equal(zx, x) and torch.equal(zd, d),
          "sweep_rows_rk_delta: 64 picks of the zero row leave both carries "
          "bitwise unchanged (a rank's foreign picks)")
    one = ops.sweep_rows_rk_delta(vals, cols, b_z[:, :1].contiguous(), rn_z,
                                  x[:, :1].contiguous(),
                                  d[:, :1].contiguous(), picks, beta=0.9)
    check(torch.equal(one[0][:, 0], got[0][:, 0])
          and torch.equal(one[1][:, 0], got[1][:, 0]),
          f"sweep_rows_rk_delta at the dense window: column 0 at k={K} "
          "bitwise equals k=1")
    round_picks = torch.randint(0, m, (DENSE_RK_STEPS,), generator=gen,
                                device=dev)
    zero = torch.zeros_like(x)
    ms = cuda_ms(lambda: ops.sweep_rows_rk_delta(*args, x, zero,
                                                 round_picks), 5)
    plain_ms = cuda_ms(lambda: ref.sweep_rows_rk_delta_ref(
        *args, x, zero, picks), 1)
    # bytes: per pick its window (n values, n ids), its b row, rn and id;
    # both carries once in and once out.  flops: 6 n k + 3 k a pick.
    work = roofline.sweep_rows_rk_delta_window(
        DENSE_RK_STEPS, n, K, value_dtype=vals.dtype, index_dtype=cols.dtype)
    b_ms, by = bound_ms(work)
    print(f"  sweep_rows_rk_delta, one dense_rk round ({DENSE_RK_STEPS} picks "
          f"of width {n}, k={K}): {ms:.4f} ms ({ms * 1e3 / DENSE_RK_STEPS:.3f}"
          f" us/pick); plain {plain_ms:.2f} ms for {DENSE_CHECK_PICKS} picks; "
          f"bound {b_ms:.5f} ms ({by})", flush=True)
    extra = dict(dense_ms=ms, dense_us_per_pick=ms * 1e3 / DENSE_RK_STEPS,
                 dense_plain_ms=plain_ms, dense_plain_picks=DENSE_CHECK_PICKS,
                 dense_bound_ms=b_ms, dense_bound_by=by,
                 dense_bytes=work.bytes, dense_flops=work.flops,
                 dense_max_abs_err=max_abs)
    del vals, cols, got, want, glob, one

    R, L = DENSE_RK_ROUNDS, DENSE_RK_STEPS
    sparse = dict(sweep_rows_rk_delta=DIST_RK_ROUNDS,
                  spmv_ell=DIST_RK_ROUNDS, colsum=2 * DIST_RK_ROUNDS)
    gs = dict(sweep_rows_gs=DIST_GS_ROUNDS, spmv_ell=2 * DIST_GS_ROUNDS,
              colsum=2 * DIST_GS_ROUNDS)
    nb = SPD_N // BLOCK
    halo = dict(banded_gs_sweep=DIST_BANDED_GS_ROUNDS,
                bbmv=2 * DIST_BANDED_GS_ROUNDS,
                colsum=2 * DIST_BANDED_GS_ROUNDS)
    with tempfile.TemporaryDirectory() as store, \
            process_group("gloo", store) as pg:
        drk = counted(
            f"distributed dense_rk, P = 1, {R} rounds of {L} local steps",
            dict(sweep_rows_rk_delta=R, colsum=2 * R),
            lambda: solve(dense, format="dense", group=pg,
                          seed=DENSE_RK_SEED,
                          schedule=Schedule(rounds=R, local_steps=L)))
        check(drk.x.shape == (n, K) and drk.tau == 0
              and drk.bytes_per_round == 0.0 and drk.lag is None,
              f"dense_rk at P = 1: x {tuple(drk.x.shape)}, tau 0, no "
              "exchange")
        falls_and_matches("dense_rk at P = 1", dense, drk)

        def rk(**kw):
            return solve(lsq, format="csr", group=pg, sync="psum",
                         seed=SEED + 11,
                         schedule=Schedule(rounds=DIST_RK_ROUNDS,
                                           local_steps=LSQ_M, **kw))

        base = counted("sparse_rk lockstep f32, P = 1", sparse, rk)
        for c in ("bf16", "int8_ef"):
            res = counted(f"sparse_rk compress={c}, P = 1", sparse,
                          functools.partial(rk, compress=c))
            check(bitwise(res, base) and res.bytes_per_round == 0.0,
                  f"sparse_rk compress={c} at P = 1: bitwise no compression "
                  "(x, err_sq, resid; nothing on the wire)")
        ov = counted("sparse_rk overlap, P = 1", sparse,
                     functools.partial(rk, overlap=True))
        check(bitwise(ov, base)
              and ov.lag.tolist() == [0] * DIST_RK_ROUNDS,
              f"sparse_rk overlap at P = 1: bitwise lockstep, lag "
              f"{ov.lag.tolist()}")

        def gs_run(prob, fmt, rounds, steps, **kw):
            fkw = (dict(block=BLOCK, bands=BANDS) if fmt == "banded"
                   else {})
            return functools.partial(
                solve, prob, format=fmt, group=pg, seed=SEED + 13,
                schedule=Schedule(rounds=rounds, local_steps=steps, **kw),
                **fkw)

        for name, prob, fmt, rounds, steps, expect in (
                ("sparse_gs", spd, "csr", DIST_GS_ROUNDS, SPD_N, gs),
                ("halo_gs", banded, "banded", DIST_BANDED_GS_ROUNDS, nb,
                 halo)):
            lock = counted(f"{name} lockstep, P = 1", expect,
                           gs_run(prob, fmt, rounds, steps))
            ov = counted(f"{name} overlap, P = 1", expect,
                         gs_run(prob, fmt, rounds, steps, overlap=True))
            check(bitwise(ov, lock) and ov.lag.tolist() == [0] * rounds,
                  f"{name} overlap at P = 1: bitwise lockstep, lag "
                  f"{ov.lag.tolist()}")
            if name == "sparse_gs":
                bal = counted("sparse_gs partition='balanced', P = 1",
                              expect, gs_run(prob, fmt, rounds, steps,
                                             partition="balanced"))
                check(bitwise(bal, lock), "sparse_gs partition='balanced' "
                      "at P = 1 (one slab: the identity permutation): "
                      "bitwise contiguous")
                falls_and_matches("sparse_gs balanced at P = 1", spd, bal)
        bal = counted("sparse_rk partition='balanced', P = 1", sparse,
                      functools.partial(rk, partition="balanced"))
        check(bitwise(bal, base), "sparse_rk partition='balanced' at P = 1: "
              "bitwise contiguous")
        falls_and_matches("sparse_rk balanced at P = 1", lsq, bal)
    relres = float((drk.resid[-1] / torch.linalg.vector_norm(
        dense.b, dim=0)).max())
    check(math.isfinite(relres), f"dense_rk at P = 1: largest final "
          f"relative residual {relres:.4e} after {R * L} picks")
    print(f"  the rest of the engine at P = 1: "
          f"{time.perf_counter() - t_phase:.2f} s wall ({smi})", flush=True)
    return dict(dense=dense, rho=rho, extra=extra)


def p4_rest_checks(torch, ops, p4, *, lsq, banded, spd, dense, skew,
                   skew_csr, band_csr, smi: str) -> None:
    """The checks of the P = 4 runs of the rest of the engine (p4_rank):
    each rank's launches exactly, x the same on every rank, the Kaczmarz
    a2a exchange bitwise the psum with fewer bytes, sync="auto" bitwise
    the psum on a dense graph, the overlap lag traces and their bound,
    dense_gs's overlap the warned lockstep, the wire sizes of the codecs,
    and convergence."""
    import math

    from repro_torch.core.distributed import (_payload_bytes, _rk_a2a_plan,
                                              _sync_bytes_per_round)
    from repro_torch.core.engine import scheduled_tau

    slab4, nb4 = SPD_N // P4, SPD_N // BLOCK // P4
    sparse = lambda r: dict(sweep_rows_rk_delta=r, spmv_ell=r,   # noqa: E731
                            colsum=2 * r)
    gs_sparse = dict(sweep_rows_gs=P4_SPARSE_GS_ROUNDS,
                     spmv_ell=2 * P4_SPARSE_GS_ROUNDS,
                     colsum=2 * P4_SPARSE_GS_ROUNDS)
    halo = dict(banded_gs_sweep=P4_BANDED_GS_ROUNDS,
                bbmv=2 * P4_BANDED_GS_ROUNDS, colsum=2 * P4_BANDED_GS_ROUNDS)
    # (tag, rounds, local steps, launches a rank, problem, whether it must
    # fall P4_CONVERGE-fold)
    table = (
        ("sparse_rk a2a", P4_A2A_ROUNDS, P4_A2A_STEPS,
         sparse(P4_A2A_ROUNDS), banded, False),
        ("sparse_rk psum (banded CSR)", P4_A2A_ROUNDS, P4_A2A_STEPS,
         sparse(P4_A2A_ROUNDS), banded, False),
        ("sparse_rk auto", P4_SPARSE_ROUNDS, P4_SPARSE_STEPS,
         sparse(P4_SPARSE_ROUNDS), lsq, True),
        ("dense_rk", P4_DENSE_RK_ROUNDS, P4_DENSE_RK_STEPS,
         dict(sweep_rows_rk_delta=P4_DENSE_RK_ROUNDS,
              colsum=2 * P4_DENSE_RK_ROUNDS), dense, False),
        ("sparse_gs overlap", P4_SPARSE_GS_ROUNDS, slab4, gs_sparse, spd,
         True),
        ("halo_gs overlap", P4_BANDED_GS_ROUNDS, nb4, halo, banded, True),
        ("sparse_rk overlap", P4_SPARSE_ROUNDS, P4_SPARSE_STEPS,
         sparse(P4_SPARSE_ROUNDS), lsq, True),
        ("dense_gs overlap", P4_BANDED_GS_ROUNDS, nb4,
         dict(block_gs_sweep=P4_BANDED_GS_ROUNDS,
              colsum=2 * P4_BANDED_GS_ROUNDS), banded, True),
        *((f"sparse_rk {c}", P4_SPARSE_ROUNDS, P4_SPARSE_STEPS,
           sparse(P4_SPARSE_ROUNDS), lsq, True) for c in ("bf16", "int8_ef")),
        *((f"halo_gs {c}", P4_BANDED_GS_ROUNDS, nb4, halo, banded, True)
          for c in ("bf16", "int8_ef")),
        ("sparse_rk balanced", P4_SPARSE_ROUNDS, P4_SPARSE_STEPS,
         sparse(P4_SPARSE_ROUNDS), skew, True))
    dev = torch.device(DEVICE)
    for name, rounds, steps, expect, prob, converges in table:
        tag = f"P = {P4} {name}, {rounds} rounds of {steps} local steps"
        res = p4[name]
        walls = [wall for _, wall, _ in res["ranks"]]
        print(f"  {tag}: wall s per rank "
              + ", ".join(f"{w:.3f}" for w in walls)
              + f" ({1e3 * max(walls) / rounds:.2f} ms a round at the "
              f"slowest rank; four CUDA contexts time-slice one card: {smi})",
              flush=True)
        for rank, (counts, _, _) in enumerate(res["ranks"]):
            check(counts == {k: expect.get(k, 0) for k in ops.KERNELS},
                  f"{tag}: rank {rank} launched exactly {expect}")
        digests = {d for _, _, d in res["ranks"]}
        check(len(digests) == 1, f"{tag}: the returned x is bitwise the "
              f"same on all {P4} ranks (SHA-256 {min(digests)[:16]})")
        resid = res["resid"]
        fall = float((resid[-1] / resid[0]).max())
        ok = bool(torch.isfinite(resid).all()) and fall < (
            P4_CONVERGE if converges else 1.0)
        x = res["x"].to(dev)
        relres = float((torch.linalg.vector_norm(prob.b - prob.A @ x, dim=0)
                        / torch.linalg.vector_norm(prob.b, dim=0)).max())
        check(ok and math.isfinite(relres),
              f"{tag}: the residual falls"
              + (f" {1 / P4_CONVERGE:g}-fold" if converges else "")
              + f" (largest last/first {fall:.4g}; column 0 "
              f"{float(resid[0, 0]):.4g} -> {float(resid[-1, 0]):.4g}); "
              f"rank 0's final relative residual (dense torch.matmul) "
              f"{relres:.3e}")
        lag = res["lag"]
        overlapped = name.endswith("overlap") and name != "dense_gs overlap"
        if overlapped:
            rk = name.startswith("sparse_rk")
            lock = scheduled_tau(P4, steps, shared_stream=rk,
                                 local_sampling=rk)
            check(lag is not None and int(lag[0]) == 0
                  and bool((lag[1:] == (P4 - 1) * steps).all())
                  and int(lag.max()) + lock <= res["tau"]
                  == scheduled_tau(P4, steps, shared_stream=rk,
                                   local_sampling=rk, overlap=True),
                  f"{tag}: lag[0] = 0, lag[1:] = (P - 1) * L = "
                  f"{(P4 - 1) * steps} ({sorted(set(lag.tolist()))}), "
                  f"max(lag) + tau_lockstep = {int(lag.max()) + lock} <= "
                  f"tau = {res['tau']}")
        else:
            check(lag is None, f"{tag}: no lag trace (lockstep rounds)")
    a2a, ps = p4["sparse_rk a2a"], p4["sparse_rk psum (banded CSR)"]
    reduce_s, bcast_s = plan = _rk_a2a_plan(band_csr.slab_neighbors(P4), P4)
    want_a2a = _sync_bytes_per_round("sparse_rk", n=SPD_N, k=K,
                                     num_workers=P4, sync="a2a",
                                     a2a_schedule=plan)
    check(all(torch.equal(a2a[f], ps[f]) for f in ("x", "resid"))
          and a2a["ranks"][0][2] == ps["ranks"][0][2],
          f"P = {P4} Kaczmarz on the banded problem in CSR: the a2a "
          "exchange's x and residuals bitwise the psum's (SHA-256 "
          f"{a2a['ranks'][0][2][:16]})")
    check([len(p) for p in reduce_s] == [P4 - 1, 0, P4 - 1]
          and [len(p) for p in bcast_s] == [P4 - 1, 0, P4 - 1]
          and a2a["bytes_per_round"] == want_a2a
          < ps["bytes_per_round"] == 4.0 * SPD_N * K,
          f"P = {P4} a2a on the banded CSR: a chain of column slabs "
          f"(reduce pairs {[len(p) for p in reduce_s]}), "
          f"{a2a['bytes_per_round']:g} bytes a rank and round against the "
          f"psum's {ps['bytes_per_round']:g}")
    auto, psum = p4["sparse_rk auto"], p4["sparse_rk"]
    check(bool(skew_csr.slab_neighbors(P4).all())
          and all(torch.equal(auto[f], psum[f]) for f in ("x", "resid"))
          and auto["bytes_per_round"] == psum["bytes_per_round"]
          == 4.0 * LSQ_N * K,
          f"P = {P4} sparse_rk sync='auto' on the LSQ design (a dense "
          "column graph): the psum, bitwise the psum run")
    fb = p4["dense_gs overlap"]
    check(any("no overlapped-sync variant" in w for w in fb["warned"])
          and torch.equal(fb["x"], p4["dense_gs"]["x"])
          and fb["tau"] == p4["dense_gs"]["tau"],
          f"P = {P4} dense_gs overlap: warned (no overlapped-sync variant) "
          "and ran the lockstep rounds, x bitwise the dense_gs run's")
    check(p4["dense_rk"]["tau"] == P4_DENSE_RK_STEPS - 1
          and p4["dense_rk"]["bytes_per_round"] == 4.0 * LSQ_N * K,
          f"P = {P4} dense_rk: tau {p4['dense_rk']['tau']} = L - 1, "
          f"{p4['dense_rk']['bytes_per_round']:g} bytes a round")
    for c in ("bf16", "int8_ef"):
        for name, f32, size, mult in (
                (f"sparse_rk {c}", psum, LSQ_N * K, 1),
                (f"halo_gs {c}", p4["halo_gs"], BANDS * BLOCK * K, 2)):
            res = p4[name]
            e = rel(res["x"], f32["x"])
            check(res["bytes_per_round"] == mult * _payload_bytes(size, c)
                  < f32["bytes_per_round"] and e <= INT8_EF_RTOL,
                  f"P = {P4} {name}: {res['bytes_per_round']:g} bytes a rank "
                  f"and round (f32 {f32['bytes_per_round']:g}); x within rel "
                  f"{e:.3e} <= {INT8_EF_RTOL:g} of the f32 wire's")


def banded_beyond_main(torch, ops, launcher, ref_banded, blocks, bands_list,
                       ks, gen, dev) -> None:
    """The banded GS and RK sweeps at ``blocks`` x ``bands_list`` x ``ks``,
    f32 and bf16 tiles, on random inputs: each against its plain
    version, its shared-memory and global paths (each forced) bitwise
    equal to what the wrapper launched, column 0 at k = 1 bitwise column 0
    at the largest k; RK also from xw = dw = 0 the two carries equal,
    and all gates 0 leaving both windows as they were."""
    nb, steps = RAGGED_NB, 2 * RAGGED_NB
    kmax = max(ks)
    for blk in blocks:
        for bands in bands_list:
            width = 2 * bands + 1
            rows_w = (nb + 2 * bands) * blk
            for vdt in (torch.float32, torch.bfloat16):
                tiles = (torch.randn((nb, width, blk, blk), generator=gen,
                                     device=dev)
                         / (width * blk) ** 0.5).to(vdt)
                b = torch.randn((nb * blk, kmax), generator=gen, device=dev)
                xw = torch.randn((rows_w, kmax), generator=gen, device=dev)
                dw = torch.randn((rows_w, kmax), generator=gen, device=dev)
                rn = torch.rand((nb, blk), generator=gen, device=dev) + 0.5
                picks = torch.randint(0, nb, (steps,), generator=gen,
                                      device=dev, dtype=torch.int32)
                gates = (torch.rand((steps,), generator=gen, device=dev)
                         < 0.5).to(torch.int32)
                kw = dict(block=blk, bands=bands, beta=0.9)
                first = {}
                for kk in sorted(ks, reverse=True):
                    tag = (f"{str(vdt)[6:]} nb={nb} block={blk} "
                           f"bands={bands} k={kk}")
                    bk, xk, dk = (t[:, :kk].contiguous() for t in (b, xw, dw))
                    got = ops.banded_gs_sweep(tiles, bk, xk, picks, **kw)
                    paths = [launcher.banded_gs_sweep(tiles, bk, xk, picks,
                                                      limit=nb, _shared=sh,
                                                      **kw)
                             for sh in (True, False)]
                    want = ref_banded.banded_gs_sweep_ref(tiles, bk, xk,
                                                          picks, **kw)
                    e = rel(got, want)
                    check(e <= SWEEP_RTOL, f"banded_gs_sweep {tag}: rel err "
                          f"{e:.3e} <= {SWEEP_RTOL:g}")
                    check(all(torch.equal(got, h) for h in paths),
                          f"banded_gs_sweep {tag}: the shared-memory and "
                          "global paths bitwise equal the wrapper's launch")
                    rgot = ops.banded_rk_sweep(tiles, bk, rn, xk, dk, picks,
                                               gates, **kw)
                    rpaths = [launcher.banded_rk_sweep(
                        tiles, bk, rn, xk, dk, picks, gates, limit=nb,
                        _shared=sh, **kw) for sh in (True, False)]
                    rwant = ref_banded.banded_rk_sweep_ref(
                        tiles, bk, rn, xk, dk, picks, gates, **kw)
                    e = max(rel(g, w) for g, w in zip(rgot, rwant))
                    check(e <= SWEEP_RTOL, f"banded_rk_sweep {tag}, mixed "
                          f"gates: rel err of xw and dw {e:.3e} <= "
                          f"{SWEEP_RTOL:g}")
                    check(all(torch.equal(g, h) for hs in rpaths
                              for g, h in zip(rgot, hs)),
                          f"banded_rk_sweep {tag}: the shared-memory and "
                          "global paths bitwise equal the wrapper's launch")
                    zero = torch.zeros_like(xk)
                    zx, zd = ops.banded_rk_sweep(tiles, bk, rn, zero, zero,
                                                 picks, torch.ones_like(gates),
                                                 **kw)
                    check(torch.equal(zx, zd) and bool(zx.any()),
                          f"banded_rk_sweep {tag}: from xw = dw = 0 the two "
                          "carries end bitwise equal")
                    same = ops.banded_rk_sweep(tiles, bk, rn, xk, dk, picks,
                                               torch.zeros_like(gates), **kw)
                    check(torch.equal(same[0], xk) and torch.equal(same[1], dk),
                          f"banded_rk_sweep {tag}: all gates 0 leave xw and "
                          "dw bitwise unchanged")
                    if kk == kmax:
                        first = dict(gs=got[:, 0], xw=rgot[0][:, 0],
                                     dw=rgot[1][:, 0])
                    elif kk == 1:
                        check(torch.equal(got[:, 0], first["gs"]),
                              f"banded_gs_sweep {tag}: column 0 bitwise "
                              f"equals column 0 at k={kmax}")
                        check(torch.equal(rgot[0][:, 0], first["xw"])
                              and torch.equal(rgot[1][:, 0], first["dw"]),
                              f"banded_rk_sweep {tag}: column 0 bitwise "
                              f"equals column 0 at k={kmax}")


def row_window_beyond_main(torch, ops, ref, spmv, main_csr, main_ell, x_main,
                           gen, dev) -> None:
    """The two row-window matvecs against their plain versions at RW_KS on
    ragged operators, each with the operator's counts bitwise equal to
    without them (the chains stopped after the first padding slot), the
    sliced pair bitwise equal, column 0 at k = 51 bitwise equal to k = 1,
    and the operators' counts equal to the stored layouts' (CSR row_nnz
    and kernels/spmv_csr.py::row_extent of the sliced view; ELL min(count,
    width))."""
    from repro_torch.core.operators import CsrOp, EllOp
    from repro_torch.tune.spmv_probe import ragged_dense

    dense = {most: ragged_dense(RW_M, RW_N, gen, dev, most)
             for most in (RW_WIDE, RW_NARROW)}
    csr = {(R, sd, most): CsrOp.from_dense(A, rows_per_panel=R,
                                           storage_dtype=sd)
           for most, A in dense.items() for R in (1, 8)
           for sd in (None, "bfloat16")}
    sq = ragged_dense(RW_M, RW_M, gen, dev, RW_WIDE)
    ells = {"exact": EllOp.from_dense(sq),
            f"width {RW_NARROW}": EllOp.from_dense(sq, width=RW_NARROW),
            "bf16": EllOp.from_dense(sq, storage_dtype="bfloat16")}
    counts = (sq != 0).sum(1).to(torch.int32)
    same = []
    for (R, sd, most), op in csr.items():
        vals, cols = op.sliced_rows()
        same.append(torch.equal(spmv.row_extent(vals, cols)[:RW_M],
                                op.row_counts())
                    and bool((spmv.row_extent(vals, cols)[RW_M:] == 0).all()))
    for name, op in ells.items():
        same.append(torch.equal(op.row_counts(), counts.clamp(max=op.width)))
    check(all(same), "row counts: CsrOp.row_counts() is row_extent of the "
          "sliced view (0 past m) and EllOp.row_counts() min(count, width) "
          f"on {len(same)} layouts")

    def within(tag, y, want, scale):
        err = (y - want).abs()
        check(bool((err <= SPMV_RTOL * scale + SPMV_ATOL).all()),
              f"{tag}: max|kernel - plain| = {float(err.max()):.3e} within "
              f"{SPMV_RTOL:g}*(|A||x|) + {SPMV_ATOL:g}")

    for k in RW_KS:
        x = torch.randn((RW_N, k), generator=gen, device=dev)
        xs = torch.randn((RW_M, k), generator=gen, device=dev)
        for (R, sd, most), op in csr.items():
            vals, cols = op.sliced_rows()
            tag = (f"spmv_csr_sliced {'bf16/i16' if sd else 'f32/i32'} "
                   f"{RW_M}x{RW_N} rows of <= {most} nonzeros (width "
                   f"{vals.shape[1]}) rows_per_panel={R} k={k}")
            kw = dict(m=RW_M, rows_per_panel=R)
            y = ops.spmv_csr_sliced(vals, cols, x, counts=op.row_counts(),
                                    **kw)
            within(tag, y, ref.spmv_csr_sliced_ref(vals, cols, x, m=RW_M),
                   ref.spmv_csr_sliced_ref(vals.abs(), cols, x.abs(), m=RW_M))
            check(torch.equal(y, ops.spmv_csr_sliced(vals, cols, x, **kw)),
                  f"{tag}: with the row counts bitwise equal to without")
            yp = ops.spmv_csr_sliced_prefetch(vals, cols, op.panel_nnz(), x,
                                              counts=op.row_counts(), **kw)
            check(torch.equal(y, yp), f"{tag}: the predicated twin bitwise "
                  f"equal ({int((op.panel_nnz() == 0).sum())} empty panels)")
        for name, op in ells.items():
            tag = f"spmv_ell {name} {RW_M} rows (width {op.width}) k={k}"
            y = ops.spmv_ell(op.vals, op.cols, xs, counts=op.row_counts())
            within(tag, y, ref.spmv_ell_ref(op.vals, op.cols, xs),
                   ref.spmv_ell_ref(op.vals.abs(), op.cols, xs.abs()))
            check(torch.equal(y, ops.spmv_ell(op.vals, op.cols, xs)),
                  f"{tag}: with the row counts bitwise equal to without")
        op = ells["exact"]
        rows = slice(RW_SLAB, 2 * RW_SLAB)
        sv, sc = op.vals[rows].contiguous(), op.cols[rows].contiguous()
        within(f"spmv_ell slab of {RW_SLAB} rows of a {RW_M}-column "
               f"operator k={k}", ops.spmv_ell(sv, sc, xs, n_cols=RW_M,
                                               counts=op.row_counts()[rows]),
               ref.spmv_ell_ref(sv, sc, xs),
               ref.spmv_ell_ref(sv.abs(), sc, xs.abs()))
    # x holding NaN, inf and -0 (the padding columns' rows too): with the
    # row counts still bitwise equal to every slot chained
    x = torch.randn((RW_N, 51), generator=gen, device=dev)
    x[0], x[3, 5], x[7, 0], x[11, :4] = -0.0, float("nan"), float("inf"), -0.0
    xs = torch.randn((RW_M, 51), generator=gen, device=dev)
    xs[:100], xs[200, 3] = -0.0, float("-inf")
    op = csr[(8, None, RW_WIDE)]
    vals, cols = op.sliced_rows()
    kw = dict(m=RW_M, rows_per_panel=8)
    ell = ells["exact"]
    def bits(t):
        return t.view(torch.int32)

    check(torch.equal(bits(ops.spmv_csr_sliced(vals, cols, x,
                                               counts=op.row_counts(), **kw)),
                      bits(ops.spmv_csr_sliced(vals, cols, x, **kw)))
          and torch.equal(bits(ops.spmv_ell(ell.vals, ell.cols, xs,
                                            counts=ell.row_counts())),
                          bits(ops.spmv_ell(ell.vals, ell.cols, xs))),
          "spmv_csr_sliced and spmv_ell on x with NaN, inf and -0: with the "
          "row counts bitwise equal to without")
    # column 0 at k = 51 against k = 1, on the main operators and ragged ones
    x51 = torch.randn((RW_N, 51), generator=gen, device=dev)
    xs51 = torch.randn((RW_M, 51), generator=gen, device=dev)
    cases = [("SPD main", main_csr, x_main)] + [
        (f"rows of <= {most}", csr[(8, None, most)], x51)
        for most in (RW_WIDE, RW_NARROW)]
    for tag, op, x in cases:
        vals, cols = op.sliced_rows()
        kw = dict(m=op.shape[0], rows_per_panel=op.rows_per_panel,
                  counts=op.row_counts())
        full = ops.spmv_csr_sliced(vals, cols, x, **kw)
        one = ops.spmv_csr_sliced(vals, cols, x[:, :1].contiguous(), **kw)
        check(torch.equal(one[:, 0], full[:, 0]),
              f"spmv_csr_sliced {tag}: column 0 at k=51 bitwise equals k=1")
        full = ops.spmv_csr_sliced_prefetch(vals, cols, op.panel_nnz(), x,
                                            **kw)
        one = ops.spmv_csr_sliced_prefetch(vals, cols, op.panel_nnz(),
                                           x[:, :1].contiguous(), **kw)
        check(torch.equal(one[:, 0], full[:, 0]),
              f"spmv_csr_sliced_prefetch {tag}: column 0 at k=51 bitwise "
              "equals k=1")
    for tag, op, x in (("SPD main", main_ell, x_main),
                       ("ragged", ells["exact"], xs51)):
        full = ops.spmv_ell(op.vals, op.cols, x, counts=op.row_counts())
        one = ops.spmv_ell(op.vals, op.cols, x[:, :1].contiguous(),
                           counts=op.row_counts())
        check(torch.equal(one[:, 0], full[:, 0]),
              f"spmv_ell {tag}: column 0 at k=51 bitwise equals k=1")


def csr_built_on_card(torch, cases) -> None:
    """Each CSR operator built on the card (``CsrOp.from_dense``) against the
    one built on the CPU from the same dense matrix: every array bitwise
    (bf16 values by their bits), every scalar and both memoised panel
    flags equal; ``torch.nonzero`` of the pattern in the CPU's row-major
    order; and ``convert.csr_from_arrays`` taking the card's arrays as the
    packed layout.  ``cases``: tag -> (dense A on the card, the card's
    operator, storage dtype)."""
    from repro_torch import convert
    from repro_torch.core.operators import CsrOp

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    for tag, (A, op, sd) in cases.items():
        A_cpu = A.cpu()
        t0 = time.perf_counter()
        cpu = CsrOp.from_dense(A_cpu, rows_per_panel=op.rows_per_panel,
                               storage_dtype=sd)
        t_cpu = time.perf_counter() - t0
        arrays = ("data", "indices", "row_id", "row_start", "row_nnz")
        same = [torch.equal(bits(getattr(op, f)).cpu(), bits(getattr(cpu, f)))
                and getattr(op, f).dtype == getattr(cpu, f).dtype
                for f in arrays]
        same.append(torch.equal(op.panel_nnz().cpu(), cpu.panel_nnz()))
        scalars = ("shape", "nnz", "row_cap", "rows_per_panel",
                   "panel_width", "_has_empty_panel", "_panel0_tail")
        same += [getattr(op, f) == getattr(cpu, f) for f in scalars]
        order = torch.equal((A != 0).nonzero().cpu(), (A_cpu != 0).nonzero())
        convert.csr_from_arrays(                # raises if not packed
            op.data.float().cpu().numpy(),
            *(getattr(op, f).cpu().numpy() for f in arrays[1:]),
            shape=op.shape, nnz=op.nnz, row_cap=op.row_cap,
            rows_per_panel=op.rows_per_panel, panel_width=op.panel_width,
            device="cpu")
        check(all(same) and order,
              f"CSR {tag}: the operator built on the card equals the CPU's "
              f"build ({len(arrays) + 1} arrays bitwise, {len(scalars)} "
              "scalars and flags), torch.nonzero on the card in the CPU's "
              "row-major order, convert.csr_from_arrays takes its layout "
              f"(CPU build {t_cpu:.3f} s)")


def segsum_beyond_main(torch, ops, ref, gen, dev) -> None:
    """The segment-sum pair at RW_KS on ragged operators (rows of 0 to
    RW_WIDE nonzeros, rows_per_panel 1 and 8, f32/i32 and bf16/i16) and on
    the three layouts of panel 0 (tune/spmv_probe.py::panel0_layouts: a
    tail after its last stored slot, filled exactly, empty), each against
    its plain version, the twins bitwise equal, column 0 at k = 51 bitwise
    equal to k = 1; and each operator's panel0_tail what its row ids say
    (panel 0 holds more slots of row 0 than row 0 stores)."""
    from repro_torch.core.operators import CsrOp
    from repro_torch.tune.spmv_probe import panel0_layouts, ragged_dense

    A = ragged_dense(RW_M, RW_N, gen, dev, RW_WIDE)
    seg = {f"rows of <= {RW_WIDE} rows_per_panel={R} "
           f"{'bf16/i16' if sd else 'f32/i32'}": CsrOp.from_dense(
               A, rows_per_panel=R, storage_dtype=sd)
           for R in (1, 8) for sd in (None, "bfloat16")}
    seg.update(panel0_layouts(gen, dev, RW_M, RW_N, RW_WIDE, RW_NARROW))
    tails = {tag: (op.segsum_rows()["panel0_tail"],
                   int((op.row_id[:op.panel_width] == 0).sum())
                   > int(op.row_nnz[0])) for tag, op in seg.items()}
    check(all(a == b for a, b in tails.values())
          and all(tails[f"R{R}_panel0_{kind}"][0] == (kind != "exact")
                  for R in (1, 8) for kind in ("tail", "exact", "empty")),
          "CsrOp.segsum_rows()['panel0_tail'] is what the row ids say on "
          f"{len(tails)} layouts, and the panel-0 layouts are what they "
          "name")

    def run(op, x, prefetch=False):
        kw = dict(m=op.shape[0], rows_per_panel=op.rows_per_panel,
                  panel_width=op.panel_width, **op.segsum_rows())
        flat = (op.data, op.indices, op.row_id)
        if prefetch:
            return ops.spmv_csr_prefetch(*flat, op.panel_nnz(), x, **kw)
        return ops.spmv_csr(*flat, x, **kw)

    def plain(op, x, data):
        return ref.spmv_csr_segsum_ref(data, op.indices, op.row_id, x,
                                       m=op.shape[0],
                                       rows_per_panel=op.rows_per_panel,
                                       panel_width=op.panel_width)

    for k in RW_KS:
        x = torch.randn((RW_N, k), generator=gen, device=dev)
        for tag, op in seg.items():
            y, yp = run(op, x), run(op, x, prefetch=True)
            err = (y - plain(op, x, op.data)).abs()
            scale = plain(op, x.abs(), op.data.abs())
            check(bool((err <= SPMV_RTOL * scale + SPMV_ATOL).all())
                  and torch.equal(y, yp),
                  f"spmv_csr {tag} (panel width {op.panel_width}) k={k}: "
                  f"max|kernel - plain| = {float(err.max()):.3e} within "
                  f"{SPMV_RTOL:g}*(|A||x|) + {SPMV_ATOL:g}, spmv_csr_prefetch "
                  "bitwise equal")
    x51 = torch.randn((RW_N, 51), generator=gen, device=dev)
    x1 = x51[:, :1].contiguous()
    check(all(torch.equal(run(op, x51, pre)[:, 0], run(op, x1, pre)[:, 0])
              for op in seg.values() for pre in (False, True)),
          f"spmv_csr and spmv_csr_prefetch on {len(seg)} layouts: column 0 "
          "at k=51 bitwise equals k=1")


def block_gs_beyond_main(torch, ops, launcher, ref, gen, dev) -> None:
    """The dense block-GS sweep on ``BGS_CASES``, f32 and bf16 A: each k
    against its plain version and two runs bitwise, column 0 at k = 1
    bitwise column 0 at the largest k; kernels/block_gs.py's plan and
    scratch size equal the source's (the plan on this card and on one with
    half its SMs and shared memory), and the plan reaches the case's
    path."""
    props = torch.cuda.get_device_properties(dev)
    sms, cap = props.multi_processor_count, props.shared_memory_per_block_optin
    reaches = {
        "two column tiles": lambda p, n, isz: p.ctiles == 2,
        "element-by-element staging": lambda p, n, isz: n * isz % 16 != 0,
        "x tiles reloaded": lambda p, n, isz: p.xbufs < p.per_cta,
        "two units a CTA": lambda p, n, isz: p.per_cta == 2,
    }
    for n, blk, stream, ks, path in BGS_CASES:
        nb = n // blk
        if stream == "random":
            picks = torch.randint(0, nb, (2 * nb,), generator=gen, device=dev,
                                  dtype=torch.int32)
        elif stream == "repeat":
            picks = torch.full((BGS_STREAM_STEPS,), 3, dtype=torch.int32,
                               device=dev)
        elif stream == "slab":   # rank 2 of 4's blocks, as dense_gs draws
            q = nb // P4
            picks = torch.randint(2 * q, 3 * q, (2 * q,), generator=gen,
                                  device=dev, dtype=torch.int32)
        else:  # blocks 4 and 5: rows 512 ... 767, both in slice 2
            picks = torch.tensor([4, 5] * (BGS_STREAM_STEPS // 2),
                                 dtype=torch.int32, device=dev)
        kmax = max(ks)
        A32 = (torch.randn((n, n), generator=gen, device=dev) / n ** 0.5
               + torch.eye(n, device=dev))
        b = torch.randn((n, kmax), generator=gen, device=dev)
        x = torch.randn((n, kmax), generator=gen, device=dev)
        for A in (A32, A32.to(torch.bfloat16)):
            isz = A.element_size()
            tag0 = f"{str(A.dtype)[6:]} n={n} block={blk} {stream} picks"
            check(all(launcher.plan(n, blk, kmax, isz, s_, c_)
                      == launcher.c_plan(n, blk, kmax, isz, s_, c_)
                      for s_, c_ in ((sms, cap), (sms // 2, cap // 2)))
                  and launcher.scratch_floats(n, blk, kmax)
                  == launcher._c_scratch_floats(n, blk, kmax),
                  f"block_gs_sweep {tag0} k={kmax}: kernels/block_gs.py's "
                  "plan and scratch size equal the source's")
            if path is not None:
                p = launcher.plan(n, blk, kmax, isz, sms, cap)
                check(reaches[path](p, n, isz),
                      f"block_gs_sweep {tag0} k={kmax}: the plan reaches "
                      f"{path} ({p})")
            first = None
            for kk in ks:
                tag = f"{tag0} k={kk}"
                bk, xk = b[:, :kk].contiguous(), x[:, :kk].contiguous()
                kw = dict(block=blk, beta=0.9)
                got = ops.block_gs_sweep(A, bk, xk, picks, **kw)
                want = ref.block_gs_sweep_ref(A, bk, xk, picks, **kw)
                e = rel(got, want)
                check(e <= SWEEP_RTOL, f"block_gs_sweep {tag}: rel err "
                      f"{e:.3e} <= {SWEEP_RTOL:g}")
                check(torch.equal(ops.block_gs_sweep(A, bk, xk, picks, **kw),
                                  got),
                      f"block_gs_sweep {tag}: two runs agree bitwise")
                if kk == kmax:
                    first = got[:, 0]
                elif kk == 1:
                    check(torch.equal(got[:, 0], first),
                          f"block_gs_sweep {tag}: column 0 bitwise equals "
                          f"column 0 at k={kmax}")
        del A32, A


def serving_phase(torch, ops, spd, lsq, launches) -> None:
    """The serving path on the card: ``SolverService.register``/``submit``
    down to the sweep, matvec and ``colsum`` kernels (checks (a)-(h)), an
    open-loop load batched and serial, ``launch.serve`` in a child
    process, and a chunk's times (from Python, from one CUDA graph, with
    the service's per-chunk host reads).  The launch counters are set to 0
    after the warmup and read after each step: a step must have launched
    one sweep, one CSR matvec and one ``colsum`` per chunk and nothing
    else.  The steps' launches go into ``launches``."""
    import numpy as np

    from repro_torch.core.engine import (draw_picks, sequential_chunk,
                                         solve_batched, solve_sequential)
    from repro_torch.serve import (RHS_BUCKETS, SolverService, bucket_rhs,
                                   open_loop_load)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 41)

    def gauss(n, k):
        return rng.standard_normal((n, k)).astype(np.float32)

    def service(max_batch=SERVE_MAX_BATCH, warm=RHS_BUCKETS, rk=True):
        svc = SolverService(num_iters=SERVE_ITERS, record_every=SERVE_REC,
                            max_batch=max_batch,
                            batch_window_s=SERVE_WINDOW_S)
        svc.register("gs", spd.A, action="gs", format="csr",
                     seed=SERVE_SEED, warmup_buckets=warm)
        if rk:
            svc.register("rk", lsq.A, action="rk", format="csr",
                         seed=SERVE_SEED + 1, num_iters=SERVE_RK_ITERS,
                         warmup_buckets=warm)
        return svc

    t0 = time.perf_counter()
    svc = service()
    print(f"  registered random_sparse_spd({SPD_N}, row_nnz={SPD_ROW_NNZ}) "
          f"as gs ({SERVE_ITERS} picks at most) and random_sparse_lsq("
          f"{LSQ_M}, {LSQ_N}) as rk ({SERVE_RK_ITERS}) on CSR, chunks of "
          f"{SERVE_REC} picks, one warmup chunk per bucket {RHS_BUCKETS}: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    gs_op, rk_op = svc._problems["gs"].op, svc._problems["rk"].op
    total = dict.fromkeys(ops.KERNELS, 0)
    chunks = {"gs": 0, "rk": 0}

    def step(tag, run):
        """``run()`` with the counters set to 0 just before it; it returns
        (its result, {action: chunks it ran}).  The counts must be one
        sweep, one matvec and one colsum a chunk, and nothing else."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res, ran = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        expect = {f"sweep_rows_{a}": c for a, c in ran.items() if c}
        expect["spmv_csr_sliced"] = expect["colsum"] = sum(ran.values())
        check(got == {name: expect.get(name, 0) for name in ops.KERNELS},
              f"serving, {tag}: launched exactly {expect} ({wall:.3f} s)")
        for name, n in got.items():
            total[name] += n
            launches[name] += n
        for a, c in ran.items():
            chunks[a] += c
        return res

    def served(s, *reqs):
        """Submit every (problem, b, keywords) before the loop starts (so
        they share a batch where they can) and wait for all: (results,
        tickets, chunks the service ran)."""
        before = s.stats.chunk_launches
        tickets = [s.submit(name, b, **kw) for name, b, kw in reqs]
        with s:
            results = [t.result(timeout=SERVE_TIMEOUT_S) for t in tickets]
        return results, tickets, s.stats.chunk_launches - before

    # (a) three tenants queued before start share one batch; a later
    # request of width 6 (bucket 8) is a batch of its own
    fresh = service(warm=(), rk=False)
    blocks = [gauss(SPD_N, w) for w in (1, 2, 3)]

    def tenants():
        rs, _, c = served(fresh, *(("gs", b, dict(rtol=SERVE_RTOL))
                                   for b in blocks))
        first = (rs, fresh.stats.batches, list(fresh.stats.batch_widths))
        (r2,), _, c2 = served(fresh, ("gs", gauss(SPD_N, 6),
                                      dict(rtol=SERVE_RTOL)))
        return (first, r2, fresh.stats.batch_widths), {"gs": c + c2}
    (rs, nb, widths), r2, widths2 = step(
        "(a) tenants of widths 1, 2, 3, then a width-6 batch", tenants)
    check(nb == 1 and widths == [6],
          f"(a) three tenants queued before start ran as one batch "
          f"(batches {nb}, widths {widths})")
    check(all(bool(r.converged.all()) and r.x.shape == b.shape
              and r.x.device.type == "cpu" and bool(
                  (r.resid.numpy() <= SERVE_RTOL
                   * np.linalg.norm(b, axis=0)).all())
              for r, b in zip(rs, blocks)),
          "(a) each tenant got its own columns on the host, converged to "
          f"rtol {SERVE_RTOL:g} (rounds "
          + ", ".join(str(r.rounds.tolist()) for r in rs) + ")")
    check(bool(r2.converged.all()) and widths2 == [6, 6],
          f"(a) a later width-6 request ran as a second batch, converged "
          f"(widths {widths2})")
    del fresh

    # (b) and (e): widths 3, 5 and 51 bitwise their unpadded solo solves;
    # the width-3 request's partials stream in order, padding stripped
    def padded_vs_solo(b, seen):
        (r,), (t,), c = served(svc, ("gs", b, dict(
            rtol=SERVE_RTOL, on_progress=seen.append)))
        solo = solve_batched(
            gs_op, torch.from_numpy(b).to(gs_op.device), action="gs",
            num_iters=SERVE_ITERS, record_every=SERVE_REC,
            tol=t.request.tol,
            generator=torch.Generator(gs_op.device).manual_seed(SERVE_SEED))
        return (r, t, solo, c), {"gs": c + solo.iters_run // SERVE_REC}

    for k in (3, 5, K):
        seen = []
        r, t, solo, c = step(
            f"(b) a width-{k} request (bucket {bucket_rhs(k)}) and its solo "
            "solve", functools.partial(padded_vs_solo, gauss(SPD_N, k), seen))
        check(torch.equal(r.x, solo.x.cpu())
              and torch.equal(r.resid, solo.resid.cpu())
              and torch.equal(r.rounds, solo.rounds)
              and bool(r.converged.all()),
              f"(b) width {k} served in bucket {bucket_rhs(k)} is bitwise its "
              f"unpadded solo solve_batched (x, resid and rounds, "
              f"{int(r.rounds.min())}-{int(r.rounds.max())}), converged")
        print(f"  width {k}: {c} chunks in {1e3 * r.latency_s:.2f} ms from "
              f"submit to result, {1e3 * r.latency_s / c:.4f} ms a chunk",
              flush=True)
        if k == 3:
            iters = [p.iters for p in t.partials]
            check(t.partials == seen and len(iters) > 1
                  and iters == sorted(set(iters))
                  and all(p.x.shape == (SPD_N, 3) and p.resid.shape == (3,)
                          and p.x.device.type == "cpu" for p in t.partials)
                  and all(i < r.iters_run for i in iters),
                  f"(e) {len(iters)} partials in increasing iteration order, "
                  "padding stripped, on the host, before the exit record")

    # (c) a loose tenant leaves its batch before a tight one
    def loose_tight():
        b0 = svc.stats.batches
        (lo, ti), (tl, tt), c = served(
            svc, ("gs", gauss(SPD_N, 1), dict(rtol=SERVE_LOOSE)),
            ("gs", gauss(SPD_N, 1), dict(rtol=SERVE_TIGHT)))
        return (lo, ti, tl, tt, svc.stats.batches - b0), {"gs": c}
    lo, ti, tl, tt, nb = step(f"(c) a loose (rtol {SERVE_LOOSE:g}) and a "
                              f"tight (rtol {SERVE_TIGHT:g}) tenant",
                              loose_tight)
    check(nb == 1 and bool(lo.converged.all()) and bool(ti.converged.all())
          and int(lo.rounds.max()) < int(ti.rounds.max())
          and len(tl.partials) < len(tt.partials),
          f"(c) in one batch the loose tenant left at record "
          f"{int(lo.rounds.max())}, the tight one at {int(ti.rounds.max())}")

    # (d) a request past its deadline leaves after one chunk, unconverged
    def deadline():
        e0 = svc.stats.deadline_expired
        (r,), _, c = served(svc, ("gs", gauss(SPD_N, 1),
                                  dict(rtol=1e-12, deadline_s=0.0)))
        return (r, svc.stats.deadline_expired - e0), {"gs": c}
    r, expired = step("(d) a request with deadline_s=0", deadline)
    check(not bool(r.converged.any()) and r.iters_run == SERVE_REC
          and expired == 1 and bool(torch.isfinite(r.resid).all()),
          f"(d) deadline_s=0: completed after one chunk ({r.iters_run} "
          f"iterations), unconverged, deadline_expired +{expired}")

    # (g) chained sequential_chunk over a solve_sequential stream
    def chained(action, op, b):
        gen = torch.Generator(op.device).manual_seed(SEED + 43)
        n_x = op.shape[0] if action == "gs" else op.shape[1]
        x0 = torch.zeros((n_x, K), device=op.device)
        picks = draw_picks(op, action, SERVE_CHAIN * SERVE_REC,
                           generator=gen)
        one = solve_sequential(op, b, x0, None, action=action,
                               num_iters=SERVE_CHAIN * SERVE_REC,
                               picks=picks, record_every=SERVE_REC)
        x, rn = x0, (op.row_norms_sq() if action == "rk" else None)
        resids = []
        for c in range(SERVE_CHAIN):
            x, resid = sequential_chunk(
                op, b, x, picks[c * SERVE_REC:(c + 1) * SERVE_REC],
                action=action, rn=rn)
            resids.append(resid)
        return (one, x, torch.stack(resids)), {action: 2 * SERVE_CHAIN}

    for action, op, b in (("gs", gs_op, spd.b), ("rk", rk_op, lsq.b)):
        one, x, resids = step(
            f"(g) {action}: solve_sequential and {SERVE_CHAIN} chained chunks",
            functools.partial(chained, action, op, b))
        check(torch.equal(x, one.x) and torch.equal(resids, one.resid),
              f"(g) {action} on CSR, k={K}: {SERVE_CHAIN} chained "
              "sequential_chunk calls are bitwise solve_sequential's final x "
              "and its record residuals")

    # (h) a Kaczmarz request (b in A's range) is bitwise its solo solve
    def rk_request():
        b = lsq.b[:, :3].contiguous()
        (r,), (t,), c = served(svc, ("rk", b, dict(rtol=SERVE_RK_RTOL)))
        solo = solve_batched(
            rk_op, b, action="rk", num_iters=SERVE_RK_ITERS,
            record_every=SERVE_REC, tol=t.request.tol,
            generator=torch.Generator(rk_op.device).manual_seed(
                SERVE_SEED + 1))
        return (r, t, solo), {"rk": c + solo.iters_run // SERVE_REC}
    r, t, solo = step(f"(h) an RK request of width 3 (rtol "
                      f"{SERVE_RK_RTOL:g}) and its solo solve", rk_request)
    b_norm = torch.linalg.vector_norm(t.request.b, dim=0).cpu()
    check(torch.equal(r.x, solo.x.cpu())
          and torch.equal(r.resid, solo.resid.cpu())
          and torch.equal(r.rounds, solo.rounds)
          and bool((r.resid < b_norm).all()),
          "(h) RK width 3 is bitwise its solo solve_batched, and its "
          "residual falls from ||b|| (x0 = 0); relative resid "
          + ", ".join(f"{v:.4e}" for v in (r.resid / b_norm).tolist())
          + (" at the first record " + ", ".join(
              f"{v:.4e}" for v in (t.partials[0].resid / b_norm).tolist())
             if t.partials else "")
          + f"; {r.iters_run} iterations, rounds {r.rounds.tolist()}, "
          f"converged {r.converged.tolist()}")

    # An open-loop load, batched then serial: the same arrivals, RHS and
    # stream, so each request must take the same rounds in both.
    def load(s):
        c0, b0 = s.stats.chunk_launches, s.stats.batches
        with s:
            rep = open_loop_load(s, "gs", requests=SERVE_LOAD_REQUESTS,
                                 rate_hz=SERVE_LOAD_HZ,
                                 rhs_widths=SERVE_LOAD_WIDTHS,
                                 rtol=SERVE_RTOL, seed=SEED + 44)
        c, nb = s.stats.chunk_launches - c0, s.stats.batches - b0
        each = list(zip(s.stats.batch_widths[-nb:],
                        s.stats.batch_chunks[-nb:],
                        s.stats.batch_seconds[-nb:]))
        return (rep, nb, c, each), {"gs": c}

    loads = {}
    for mode, s in (("batched", svc), ("serial", None)):
        if s is None:
            s = service(max_batch=1, warm=SERVE_LOAD_WIDTHS, rk=False)
        rep, nb, c, each = loads[mode] = step(
            f"open-loop load, {mode}", functools.partial(load, s))
        window = nb * SERVE_WINDOW_S / rep.makespan_s
        print(f"  load {mode}: {SERVE_LOAD_REQUESTS} requests at "
              f"{SERVE_LOAD_HZ:g} Hz, widths {SERVE_LOAD_WIDTHS}, rtol "
              f"{SERVE_RTOL:g}: qps {rep.qps:.3f}, p50 {rep.p50_ms:.3f} ms, "
              f"p99 {rep.p99_ms:.3f} ms, mean {rep.mean_ms:.3f} ms, makespan "
              f"{rep.makespan_s:.4f} s, batches {nb}, chunk_launches {c}, "
              f"admission window {100 * window:.2f}% of the makespan; "
              "batches (width, chunks, s, ms a chunk): "
              + ", ".join(f"({w}, {n}, {t:.4f}, {1e3 * t / n:.4f})"
                          for w, n, t in each), flush=True)
        check(rep.converged == SERVE_LOAD_REQUESTS,
              f"load {mode}: every request converged ({rep.converged})")
    check(loads["batched"][1] < SERVE_LOAD_REQUESTS,
          f"load batched: {loads['batched'][1]} batches for "
          f"{SERVE_LOAD_REQUESTS} requests")
    check(loads["batched"][0].rounds_per_request
          == loads["serial"][0].rounds_per_request,
          "each request of the load took the same rounds batched and serial "
          "(" + ", ".join(map(str, loads["serial"][0].rounds_per_request))
          + ")")
    check(total == {name: {"sweep_rows_gs": chunks["gs"],
                           "sweep_rows_rk": chunks["rk"],
                           "spmv_csr_sliced": sum(chunks.values()),
                           "colsum": sum(chunks.values())}.get(name, 0)
                    for name in ops.KERNELS},
          f"(f) across the serving phase {chunks} chunks, each one sweep, "
          "one CSR matvec and one colsum, and nothing else ("
          + str({k: v for k, v in total.items() if v}) + ")")

    # launch.serve in a child process
    t0 = time.perf_counter()
    argv = ["--n", str(SERVE_CLI_N), "--row-nnz", str(SPD_ROW_NNZ),
            "--requests", str(SERVE_CLI_REQUESTS), "--max-iters",
            str(SERVE_CLI_ITERS), "--record-every", str(SERVE_CLI_REC)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        text = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in text.splitlines()[-8:]:
        print(f"    [launch.serve] {line}", flush=True)
    said = [ln for ln in text.splitlines() if ln.startswith("[serve]")]
    fields = dict(f.split("=", 1) for f in said[0].split()[1:] if "=" in f
                  ) if said else {}
    check(proc.returncode == 0 and len(said) == 2
          and fields.get("converged") == str(SERVE_CLI_REQUESTS),
          f"python -m repro_torch.launch.serve {' '.join(argv)} exited 0 "
          f"with both [serve] lines, converged={fields.get('converged')} of "
          f"{SERVE_CLI_REQUESTS} ({time.perf_counter() - t0:.2f} s)")

    # One chunk's times, printed and not checked: from Python, replayed
    # from one CUDA graph, and on the host's clock with the service's
    # per-chunk reads (the resid for the tolerance test; the partials' copy
    # of x's real columns).
    picks = torch.randint(0, SPD_N, (SERVE_REC,), dtype=torch.int32,
                          generator=torch.Generator(gs_op.device)
                          .manual_seed(SEED + 45), device=gs_op.device)

    def host_ms(b, x, reads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_TIME_REPS):
            x, resid = sequential_chunk(gs_op, b, x, picks, action="gs")
            if reads >= 1:
                resid.cpu()
            if reads >= 2:
                x[:, :b.shape[1] - 1].cpu()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SERVE_TIME_REPS

    for kb in (4, 64):
        b = torch.randn((SPD_N, kb), generator=torch.Generator(
            gs_op.device).manual_seed(SEED + 46), device=gs_op.device)
        x = torch.zeros_like(b)
        chunk = functools.partial(sequential_chunk, gs_op, b, x, picks,
                                  action="gs")
        py_ms = cuda_ms(chunk, SERVE_TIME_REPS)
        g_ms = graph_ms(chunk, SERVE_TIME_REPS)
        sweep_ms = cuda_ms(functools.partial(gs_op.gs_sweep, b, x, picks),
                           SERVE_TIME_REPS)
        host_ms(b, x, 2)
        bare, resid_ms, partial_ms = (host_ms(b, x, 0), host_ms(b, x, 1),
                                      host_ms(b, x, 2))
        print(f"  chunk of {SERVE_REC} picks at k={kb} (sweep + matvec + "
              f"colsum): {py_ms:.4f} ms from Python (CUDA events), "
              f"{g_ms:.4f} ms from one CUDA graph, the sweep alone "
              f"{sweep_ms:.4f} ms; host clock per chunk {bare:.4f} ms with "
              f"no read, {resid_ms:.4f} ms with the resid read, "
              f"{partial_ms:.4f} ms with the resid read and the partials' "
              f"copy of x ({kb - 1} columns): host share "
              f"{100 * (1 - g_ms / partial_ms):.1f}%", flush=True)
    print(f"  serving phase: {time.perf_counter() - t_phase:.2f} s wall",
          flush=True)


def cli_numbers(text: str, prefix: str) -> dict:
    """The ``key=value`` numbers and the ``resid``/``relresid`` and
    ``(... s)`` wall seconds of the CLI output line that starts with
    ``prefix`` (after its indent); {} when there is no such line."""
    import re
    for line in text.splitlines():
        if line.strip().startswith(prefix):
            out = {k: float(v) for k, v in re.findall(
                r"([A-Za-z_~]+(?:\([a-z_~]+(?:=[0-9]+)?\))?)="
                r"(-?[0-9.]+(?:e[-+][0-9]+)?|nan|inf)", line)}
            m = re.search(r"(?:rel)?resid (-?[0-9.]+e[-+][0-9]+|nan|inf)",
                          line)
            if m:
                out["resid"] = float(m.group(1))
            m = re.search(r"\(([0-9.]+)s", line)
            if m:
                out["s"] = float(m.group(1))
            m = re.search(r"<= (-?[0-9.]+)", line)
            if m:
                out["factor"] = float(m.group(1))
            return out
    return {}


def sequential_cli_phase(torch, ops, lsq, launches) -> None:
    """The sequential CLIs, the bounded-delay simulator, the CG baselines
    and the theory on the card: (a) ``launch.solve`` and ``launch.lsq`` in
    this process at the main path's full width, with their launch counts;
    (b) both CLIs as ``python -m`` children at their reference defaults;
    (c) the simulator at fig3_async_penalty's size and the RK simulator,
    bitwise sequential GS at tau = 0, converging, the card against the CPU
    on the same streams, no host read in a step; (d) flexible CG with one
    ``block_gs_sweep`` launch per preconditioner application; (e)
    ``lanczos_extreme_eigs`` and ``rk_rho`` timed; (f) TF32 still off.
    Every driven path's launches go into ``launches``."""
    import contextlib
    import io
    import math

    from repro_torch.core import (DenseOp, SPDProblem, async_rgs_solve,
                                  async_rk_solve, cg_solve, fcg_solve,
                                  laplacian_spd, make_rgs_preconditioner,
                                  random_lsq, random_sparse_spd, rgs_solve,
                                  theory)
    from repro_torch.core.engine import draw_delays, draw_picks
    from repro_torch.kernels import ref
    from repro_torch.launch import lsq as lsq_cli
    from repro_torch.launch import solve as solve_cli

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)

    def counted(tag, expect, run):
        """``run()`` with the counters set to 0 just before it; its launches
        must be exactly ``expect`` and go into ``launches``."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        check(got == {name: expect.get(name, 0) for name in ops.KERNELS},
              f"{tag}: launched exactly {expect} ({wall:.3f} s)")
        for name, n in got.items():
            launches[name] += n
        return out, wall

    def in_process(cli, argv):
        """``cli.main(argv)`` with its printed lines and warnings kept."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            result = cli.main(list(argv))
        for line in buf.getvalue().splitlines():
            print(f"    [{cli.__name__.rsplit('.', 1)[-1]}] {line}",
                  flush=True)
        return result, buf.getvalue(), [str(w.message) for w in caught]

    def unit(v):
        return 0.0 < v <= 1.0

    # (b) started first: the two children run while this process runs
    # the simulator's CPU reference runs below, and are joined before any
    # timed work on the card.
    children = {
        "launch.solve --format ell": ("repro_torch.launch.solve",
                                      ["--format", "ell"],
                                      ("[solve]", "sync RGS", "async RGS",
                                       "CG", "theory")),
        f"launch.solve --sync auto --workers {P4}": (
            "repro_torch.launch.solve", ["--sync", "auto", "--workers",
                                         str(P4)],
            ("[solve]", "sync RGS", "async RGS", "CG", "theory")),
        "launch.lsq --format dense": ("repro_torch.launch.lsq",
                                      ["--format", "dense"],
                                      ("[lsq]", "seq RK", "async RK",
                                       "par RK", "CG (A^T A)", "theory")),
        f"launch.lsq --workers {P4}": (
            "repro_torch.launch.lsq", ["--workers", str(P4)],
            ("[lsq]", "seq RK", "async RK", "par RK", "CG (A^T A)",
             "theory")),
        f"launch.lsq --format csr --workers {P4} --rk-sync a2a --overlap "
        "--compress int8_ef": (
            "repro_torch.launch.lsq",
            ["--format", "csr", "--workers", str(P4), "--rk-sync", "a2a",
             "--overlap", "--compress", "int8_ef"],
            ("[lsq]", "seq RK", "async RK", "par RK", "staleness",
             "CG (A^T A)", "theory"))}
    t_children = time.perf_counter()
    procs = {what: subprocess.Popen(
        [sys.executable, "-m", mod, *argv], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for what, (mod, argv, _) in children.items()}
    try:
        # (c) first half: the problems and streams on the host, and the
        # CPU runs at SIM_CPU_TAU that the card's runs are held to.
        sim_cpu = random_sparse_spd(SIM_N, row_nnz=16, offdiag=0.95,
                                    n_rhs=SIM_K, seed=SEED, device="cpu")
        steps = SIM_SWEEPS * SIM_N
        sim_picks = torch.randint(0, SIM_N, (steps,),
                                  generator=torch.Generator().manual_seed(
                                      SEED + 51))
        rho = float(theory.rho(sim_cpu.A))
        rho2 = float(theory.rho2(sim_cpu.A))
        runs = {}
        for tau in SIM_TAUS:
            for mode in ("fixed", "uniform", "cyclic", "inconsistent"):
                model = "inconsistent" if mode == "inconsistent" else \
                    "consistent"
                beta = (theory.beta_opt_inconsistent(rho2, tau)
                        if model == "inconsistent" else 1.0)
                delays = draw_delays(
                    steps, tau, read_model=model, delay_mode=mode,
                    miss_prob=0.5, generator=torch.Generator().manual_seed(
                        SEED + 52 + tau))
                kw = dict(num_iters=steps, tau=tau, picks=sim_picks,
                          delays=delays, beta=beta, read_model=model,
                          delay_mode="fixed" if model == "inconsistent"
                          else mode, record_every=SIM_N)
                cpu = (async_rgs_solve(sim_cpu.A, sim_cpu.b,
                                       torch.zeros_like(sim_cpu.b),
                                       sim_cpu.x_star, **kw)
                       if tau == SIM_CPU_TAU else None)
                runs[(tau, mode)] = (kw, cpu)
        rk_cpu = random_lsq(SIM_RK_M, SIM_RK_N, n_rhs=SIM_RK_K, noise=0.0,
                            col_scale=0.5, seed=SEED, device="cpu")
        rk_steps = SIM_RK_SWEEPS * SIM_RK_M
        rk_picks = draw_picks(DenseOp(rk_cpu.A), "rk", rk_steps,
                              generator=torch.Generator().manual_seed(
                                  SEED + 53))
        rk_beta = theory.beta_opt_rk(float(theory.rk_rho(rk_cpu.A)),
                                     SIM_RK_TAU)
        rk_kw = dict(num_iters=rk_steps, tau=SIM_RK_TAU, picks=rk_picks,
                     delays=draw_delays(rk_steps, SIM_RK_TAU,
                                        read_model="consistent",
                                        delay_mode="fixed", miss_prob=0.5,
                                        generator=None),
                     beta=rk_beta, record_every=SIM_RK_M)
        rk_cpu_res = async_rk_solve(rk_cpu.A, rk_cpu.b,
                                    torch.zeros_like(rk_cpu.x_star),
                                    rk_cpu.x_star, **rk_kw)
        outs = {what: proc.communicate(timeout=CLI_TIMEOUT_S)[0]
                for what, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for what, proc in procs.items():
        text = outs[what]
        for line in text.splitlines()[-8:]:
            print(f"    [{what}] {line}", flush=True)
        prefixes = children[what][2]
        said = {pf: cli_numbers(text, pf) for pf in prefixes}
        finite = all(math.isfinite(v) for d in said.values()
                     for v in d.values())
        check(proc.returncode == 0 and all(said.values()) and finite,
              f"(b) python -m repro_torch.{what} exited 0 with its lines "
              f"{', '.join(prefixes)}, every number finite")
        if "par RK" in said:
            par = said["par RK"]
            workers = P4 if "--workers" in children[what][1] else 1
            check(par.get("P") == workers and 0 <= par["resid"] < 1,
                  f"(b) {what}: the distributed pass ran on {workers} "
                  f"rank(s), tau {par.get('tau')}, beta~ "
                  f"{par.get('beta~')}, relative residual {par['resid']:.3e}"
                  f" < 1 (the start) ({par.get('s')} s a rank; the ranks "
                  "time-slice one card)")
            continue
        if "async RGS" not in said:
            continue
        workers = P4 if "--workers" in children[what][1] else 1
        asy = said["async RGS"]
        check(asy.get("P") == workers
              and asy.get("tau") == (workers - 1) * (2048 // workers),
              f"(b) {what}: the distributed pass ran on {workers} "
              f"rank(s), tau {asy.get('tau')}, resid {asy['resid']:.3e} "
              f"({asy.get('s')} s a rank; the ranks time-slice one card)")
    print(f"  (b) both children and the simulator's CPU runs: "
          f"{time.perf_counter() - t_children:.2f} s", flush=True)

    # (a) launch.solve in process: GS_SWEEPS sweeps (one sweep_rows_gs
    # launch each), a record a sweep (two CSR matvecs, two colsum); its
    # distributed pass on the one card, P = 1 in process: sparse_gs, a
    # round a sweep (one sweep_rows_gs, two spmv_ell, two colsum); then CG
    # (its dots and records through colsum: 1 + 4 an iteration).
    argv = ("--format", "csr", "--n", str(SPD_N), "--rhs", str(K),
            "--sweeps", str(GS_SWEEPS))
    (res, text, _), wall = counted(
        f"(a) launch.solve {' '.join(argv)}",
        {"sweep_rows_gs": 2 * GS_SWEEPS, "spmv_csr_sliced": 2 * GS_SWEEPS,
         "spmv_ell": 2 * GS_SWEEPS,
         "colsum": 4 * GS_SWEEPS + 1 + 4 * GS_SWEEPS},
        lambda: in_process(solve_cli, argv))
    sync, asy, cgl, th = (cli_numbers(text, p) for p in (
        "sync RGS", "async RGS", "CG", "theory"))
    b0 = float(torch.linalg.vector_norm(res["problem"].b[:, 0]))
    check(all(math.isfinite(d.get("resid", math.nan)) and d["resid"] < b0
              for d in (sync, asy, cgl))
          and bool(torch.isfinite(res["sync"].resid).all())
          and bool(torch.isfinite(res["async"].resid).all())
          and bool(torch.isfinite(res["cg"].resid).all()),
          f"(a) launch.solve: resid finite and below ||b[:, 0]|| = {b0:.4g} "
          f"(sync RGS {sync.get('resid')}, async RGS {asy.get('resid')}, CG "
          f"{cgl.get('resid')})")
    check(asy.get("P") == 1 and asy.get("tau") == 0
          and res["async"].bytes_per_round == 0.0,
          f"(a) launch.solve: the distributed pass at P = 1 on the one card "
          f"(tau {asy.get('tau')}, no exchange)")
    check(unit(th.get("beta~", 0)) and unit(th.get("nu_tau(beta~)", 0))
          and unit(th.get("factor", 0)),
          f"(a) launch.solve: 0 < beta~ = {th.get('beta~')} <= 1, rate "
          f"factors nu_tau(beta~) = {th.get('nu_tau(beta~)')} and epoch "
          f"factor {th.get('factor')} in (0, 1]")
    print(f"  (a) launch.solve wall s: sync RGS {sync.get('s')}, async RGS "
          f"(P = 1) {asy.get('s')}, CG {cgl.get('s')}, the whole call "
          f"{wall:.3f} (problem build included)", flush=True)

    # launch.lsq in process: one sweep_rows_rk launch a sweep, a record a
    # sweep (one CSR matvec, two colsum); the async pass densifies (with
    # the warning) and records through colsum; the distributed pass at
    # P = 1 in process, sparse_rk, a round a sweep (one
    # sweep_rows_rk_delta, one spmv_ell, two colsum); CG on the normal
    # equations 1 + 4 an iteration.
    argv = ("--format", "csr", "--m", str(LSQ_M), "--n", str(LSQ_N), "--rhs",
            str(K), "--sweeps", str(CLI_LSQ_SWEEPS), "--tau", str(CLI_TAU))
    (res, text, warned), wall = counted(
        f"(a) launch.lsq {' '.join(argv)}",
        {"sweep_rows_rk": CLI_LSQ_SWEEPS, "spmv_csr_sliced": CLI_LSQ_SWEEPS,
         "sweep_rows_rk_delta": CLI_LSQ_SWEEPS, "spmv_ell": CLI_LSQ_SWEEPS,
         "colsum": 4 * CLI_LSQ_SWEEPS + 1 + 4 * CLI_LSQ_SWEEPS
         + 2 * CLI_LSQ_SWEEPS},
        lambda: in_process(lsq_cli, argv))
    seq, asy, par, cgn, th = (cli_numbers(text, p) for p in (
        "seq RK", "async RK", "par RK", "CG (A^T A)", "theory"))
    check(all(math.isfinite(d.get("resid", math.nan)) and d["resid"] < 1.0
              for d in (seq, asy, par, cgn)),
          f"(a) launch.lsq: relative residuals finite and below 1, the "
          f"start (seq RK {seq.get('resid')}, async RK {asy.get('resid')}, "
          f"par RK {par.get('resid')}, CG {cgn.get('resid')})")
    check(par.get("P") == 1 and par.get("tau") == 0
          and res["par"].bytes_per_round == 0.0,
          f"(a) launch.lsq: the distributed pass at P = 1 on the one card "
          f"(tau {par.get('tau')}, no exchange, {par.get('s')} s)")
    check(unit(asy.get("beta~", 0)) and unit(th.get("sync", 0))
          and unit(th.get(f"async(tau={CLI_TAU})", 0)),
          f"(a) launch.lsq: 0 < beta~ = {asy.get('beta~')} <= 1, rate "
          f"factors sync {th.get('sync')} and async "
          f"{th.get(f'async(tau={CLI_TAU})')} in (0, 1]")
    check(any("densifies CsrOp exactly" in w for w in warned),
          "(a) launch.lsq: the simulator warned that it densifies the CSR "
          "operator")
    rk_full = CLI_LSQ_SWEEPS * LSQ_M
    print(f"  (a) launch.lsq wall s: seq RK {seq.get('s')}, async RK "
          f"{asy.get('s')} ({1e6 * asy.get('s', math.nan) / rk_full:.2f} "
          f"us a step over {rk_full} steps at {LSQ_M}x{LSQ_N}, k={K}; the "
          f"densify included), CG {cgn.get('s')}, theory (two svdvals) "
          f"{th.get('s')}; the whole call {wall:.3f}", flush=True)

    # (c) the simulator on the card, on the CPU runs' streams
    sim = SPDProblem(*(t.to(dev) for t in sim_cpu))
    x0 = torch.zeros_like(sim.b)
    e0 = (sim.x_star * (sim.A @ sim.x_star)).sum(0)
    (seq0, asy0), _ = counted(
        f"(c) tau=0: rgs_solve and async_rgs_solve, {steps} steps each",
        {"colsum": 4 * SIM_SWEEPS},
        lambda: (rgs_solve(sim.A, sim.b, x0, sim.x_star, num_iters=steps,
                           picks=sim_picks, record_every=SIM_N),
                 async_rgs_solve(sim.A, sim.b, x0, sim.x_star,
                                 num_iters=steps, tau=0, picks=sim_picks,
                                 record_every=SIM_N)))
    check(torch.equal(asy0.x, seq0.x) and torch.equal(asy0.err_sq,
                                                      seq0.err_sq),
          f"(c) tau=0: async_rgs_solve is bitwise rgs_solve on the same "
          f"{steps} picks (x and err_sq)")

    def no_sync(fn):
        """``fn()`` with any host synchronization an error."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(), None
        except RuntimeError as e:
            return None, str(e)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    times = []
    for (tau, mode), (kw, cpu) in runs.items():
        tag = f"(c) tau={tau} {mode} beta={kw['beta']:.4f}"
        (out, err), wall = counted(
            tag, {"colsum": 2 * SIM_SWEEPS},
            lambda kw=kw: no_sync(lambda: async_rgs_solve(
                sim.A, sim.b, x0, sim.x_star, **kw)))
        check(err is None, f"{tag}: no host synchronization in the solve "
              f"(sync debug mode 'error'; {err})")
        times.append(wall)
        fall = float((out.err_sq[-1] / e0).max())
        need = SIM_INC_FALL if mode == "inconsistent" else SIM_FALL
        cond = (f"2 rho tau = {2 * rho * tau:.4f} < 1" if mode !=
                "inconsistent" else f"omega_tau(beta) = "
                f"{theory.omega_tau(rho2, tau, kw['beta']):.4f} > 0")
        check(fall <= need and bool(torch.isfinite(out.x).all()),
              f"{tag}: err_sq falls to {fall:.3e} <= {need:g} of its start "
              f"({cond}); {1e6 * wall / steps:.2f} us a step")
        if cpu is not None:
            e = rel(out.x.cpu(), cpu.x)
            ee = float(((out.err_sq[-1].cpu() - cpu.err_sq[-1]).abs()
                        / cpu.err_sq[-1]).max())
            check(e <= SIM_RTOL and ee <= SIM_ERR_RTOL,
                  f"{tag}: the card against the CPU on the same streams: "
                  f"x rel {e:.3e} <= {SIM_RTOL:g}, last err_sq rel "
                  f"{ee:.3e} <= {SIM_ERR_RTOL:g}")
    print(f"  (c) simulator, n={SIM_N} k={SIM_K}: {1e6 * min(times) / steps:.2f}"
          f"-{1e6 * max(times) / steps:.2f} us a step over "
          f"{len(times)} runs of {steps} steps", flush=True)

    rk_prob = tuple(t.to(dev) for t in rk_cpu)
    (out, err), wall = counted(
        f"(c) async_rk_solve random_lsq({SIM_RK_M}, {SIM_RK_N}) tau="
        f"{SIM_RK_TAU}", {"colsum": 2 * SIM_RK_SWEEPS},
        lambda: no_sync(lambda: async_rk_solve(
            rk_prob[0], rk_prob[1], torch.zeros_like(rk_prob[2]),
            rk_prob[2], **rk_kw)))
    check(err is None, "(c) async_rk_solve: no host synchronization in the "
          f"solve ({err})")
    e = rel(out.x.cpu(), rk_cpu_res.x)
    r0 = torch.linalg.vector_norm(rk_prob[1], dim=0)
    check(e <= SIM_RTOL and bool((out.resid[-1] < r0).all()),
          f"(c) async_rk_solve: the card against the CPU, x rel {e:.3e} <= "
          f"{SIM_RTOL:g}; the residual falls from ||b|| (relative "
          f"{float((out.resid[-1] / r0).max()):.4e}); beta~ {rk_beta:.4f}; "
          f"{1e6 * wall / rk_steps:.2f} us a step ({rk_steps} steps, "
          f"{SIM_RK_M}x{SIM_RK_N}, k={SIM_RK_K})")

    # (d) flexible CG on the 2-D Laplacian, against plain CG
    t0 = time.perf_counter()
    lap = laplacian_spd(FCG_SIDE, shift=1e-2, n_rhs=K, seed=SEED)
    torch.cuda.synchronize()
    print(f"  (d) laplacian_spd({FCG_SIDE}), n={lap.n}, k={K}: "
          f"{time.perf_counter() - t0:.2f} s, kappa {float(lap.kappa):.1f}",
          flush=True)
    x0 = torch.zeros_like(lap.x_star)
    nb = lap.n // FCG_BLOCK
    probe = make_rgs_preconditioner(lap.A, sweeps=FCG_SWEEPS,
                                    block=FCG_BLOCK, beta=1.0,
                                    seed=SEED + 61)
    got = probe(lap.b)
    want = ref.block_gs_sweep_ref(
        lap.A, lap.b, torch.zeros_like(lap.b), torch.randint(
            0, nb, (FCG_SWEEPS * nb,), device=dev,
            generator=torch.Generator(dev).manual_seed(SEED + 61)),
        block=FCG_BLOCK, beta=1.0)
    e = rel(got, want)
    check(e <= SWEEP_RTOL, f"(d) one preconditioner application "
          f"({FCG_SWEEPS * nb} blocks of {FCG_BLOCK}) against "
          f"block_gs_sweep_ref: rel err {e:.3e} <= {SWEEP_RTOL:g}")
    plain, plain_s = counted(
        f"(d) cg_solve, {FCG_ITERS} iterations",
        {"colsum": 1 + 4 * FCG_ITERS},
        lambda: cg_solve(lap.A, lap.b, x0, lap.x_star, num_iters=FCG_ITERS))
    pre = make_rgs_preconditioner(lap.A, sweeps=FCG_SWEEPS, block=FCG_BLOCK,
                                  beta=1.0)
    applied = []

    def precond(r):
        applied.append(1)
        return pre(r)

    flex, flex_s = counted(
        f"(d) fcg_solve, {FCG_ITERS} iterations ({FCG_ITERS + 1} "
        "preconditioner applications)",
        {"block_gs_sweep": FCG_ITERS + 1, "colsum": 1 + 5 * FCG_ITERS},
        lambda: fcg_solve(lap.A, lap.b, x0, lap.x_star, precond=precond,
                          num_iters=FCG_ITERS))
    fr, pr = float(flex.resid[-1].max()), float(plain.resid[-1].max())
    f0 = float(flex.resid[0].max())
    check(len(applied) == FCG_ITERS + 1 and fr < pr and fr < 1e-2 * f0,
          f"(d) FCG's last residual {fr:.4e} is below plain CG's {pr:.4e} "
          f"after {FCG_ITERS} iterations and below 1e-2 of its first "
          f"({f0:.4e}); one block_gs_sweep launch for each of "
          f"{len(applied)} applications; wall s FCG {flex_s:.3f}, CG "
          f"{plain_s:.3f}")
    del lap, pre, probe, got, want

    # (e) the theory on the card
    t0 = time.perf_counter()
    lo, hi = theory.lanczos_extreme_eigs(
        sim.A, generator=torch.Generator(dev).manual_seed(SEED + 71))
    lo, hi = float(lo), float(hi)
    lz_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dlo, dhi = (float(v) for v in theory.extreme_eigs_dense(sim.A))
    dense_s = time.perf_counter() - t0
    check(abs(lo - dlo) <= LANCZOS_RTOL * dlo
          and abs(hi - dhi) <= LANCZOS_RTOL * dhi,
          f"(e) lanczos_extreme_eigs (64 iterations, {lz_s:.3f} s) "
          f"[{lo:.6f}, {hi:.6f}] against eigvalsh ({dense_s:.3f} s) "
          f"[{dlo:.6f}, {dhi:.6f}] within rtol {LANCZOS_RTOL:g}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rk_rho = float(theory.rk_rho(lsq.A))
    rho_s = time.perf_counter() - t0
    A64 = lsq.A.double()
    Ahat = A64 / torch.sqrt((A64 * A64).sum(1))[:, None]
    p64 = (A64 * A64).sum(1)
    p64 = p64 / p64.sum()
    want = max(float(((Ahat[i:i + LSQ_N] @ Ahat.T).abs() @ p64).max())
               for i in range(0, LSQ_M, LSQ_N))
    del A64, Ahat
    check(unit(rk_rho) and abs(rk_rho - want) <= RK_RHO_RTOL * want,
          f"(e) rk_rho of the {LSQ_M}x{LSQ_N} design ({LSQ_M}^2 Gram "
          f"matrix, {rho_s:.3f} s) {rk_rho:.6f} in (0, 1], against f64 by "
          f"row blocks {want:.6f} within rtol {RK_RHO_RTOL:g}")

    # (f)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "(f) torch.backends.cuda.matmul.allow_tf32 is still False after "
          "the CLIs ran: CG's f32 products stayed f32")
    print(f"  sequential CLI phase: {time.perf_counter() - t_phase:.2f} s "
          "wall", flush=True)


def csr_block_gs_phase(torch, ops, ref, sweep_csr, spd, drive, smi):
    """Block GS on CSR at the main path's width (k = K): the block sweep
    kernel against its plain version (f32 and bf16 storage), at block 1
    bitwise ``sweep_rows_gs``, its two paths bitwise equal, column 0 at
    k = K bitwise k = 1; ``solve(format="csr", gs_block=B)`` through
    ``drive`` (exactly one sweep launch a record chunk), the residual
    falling and the A-norm error non-increasing over its sweeps, the final
    residual against dense ``torch.matmul`` (of the stored coefficients);
    chained serving chunks bitwise ``solve_sequential``; a chunk's time
    from Python and from a CUDA graph at each block, the paths in turns.
    Returns the solves with their keywords (for the solo column checks)
    and what the kernel's JSON entry needs."""
    from repro_torch import (Schedule, a_norm_sq, as_operator,
                             random_sparse_spd, solve)
    from repro_torch.core.engine import sequential_chunk, solve_sequential

    dev = spd.A.device
    n = SPD_N
    gen = torch.Generator(dev).manual_seed(CSR_BGS_SEED)
    x0 = torch.randn((n, K), generator=gen, device=dev)
    csr = {sd: as_operator(spd.A, "csr", storage_dtype=sd)
           for sd in (None, "bfloat16")}
    cap = sweep_csr.shared_capacity(dev)

    def held(tag, vals, cols, b, x, picks, blk):
        """The kernel against its plain version, its two paths bitwise,
        column 0 at k = K bitwise k = 1; returns its max abs error."""
        m = x.shape[0]
        got = ops.sweep_rows_block_gs(vals, cols, b, x, picks, block=blk,
                                      beta=0.9)
        want = ref.sweep_rows_block_gs_ref(vals, cols, b, x, picks,
                                           block=blk, beta=0.9)
        torch.cuda.synchronize()
        e = rel(got, want)
        check(e <= SWEEP_RTOL, f"sweep_rows_block_gs {tag} n={m} k={K} "
              f"block {blk}, {picks.numel()} picks: rel err {e:.3e} <= "
              f"{SWEEP_RTOL:g}")
        p32 = picks.to(torch.int32)
        paths = [sweep_csr.sweep_rows_block_gs(
            vals, cols, b, x, p32, block=blk, beta=0.9, limit=m // blk,
            _shared=shared) for shared in (True, False)]
        check(all(torch.equal(p, got) for p in paths),
              f"sweep_rows_block_gs {tag} block {blk}: the shared-memory "
              "and the global path bitwise equal")
        one = ops.sweep_rows_block_gs(
            vals, cols, b[:, :1].contiguous(), x[:, :1].contiguous(), picks,
            block=blk, beta=0.9)
        check(torch.equal(one[:, 0], got[:, 0]),
              f"sweep_rows_block_gs {tag} block {blk}: column 0 at k={K} "
              "bitwise equals k=1")
        return float((got - want).abs().max())

    errs = {}
    for sd, op in csr.items():
        tag = "f32/i32" if sd is None else "bf16/i16"
        vals, cols = op.padded_rows()
        for blk, steps in CSR_BGS_CHECK.items():
            picks = torch.randint(0, n // blk, (steps,), generator=gen,
                                  device=dev)
            errs[(sd, blk)] = held(tag, vals, cols, spd.b, x0, picks, blk)
        plan = sweep_csr.block_plan(n, vals.shape[1], 1000,
                                    vals.element_size(), cols.element_size(),
                                    cap)
        check(plan.shared and 0 < plan.tile_rows < 1000,
              f"sweep_rows_block_gs {tag} block 1000: a pick goes through "
              f"the ring in tiles beside x ({plan})")
        picks = torch.randint(0, n, (PREFIX,), generator=gen, device=dev)
        coord = ops.sweep_rows_gs(vals, cols, spd.b, x0, picks, beta=0.9)
        p32 = picks.to(torch.int32)
        check(all(torch.equal(sweep_csr.sweep_rows_block_gs(
                  vals, cols, spd.b, x0, p32, block=1, beta=0.9, limit=n,
                  _shared=shared), coord) for shared in (True, False)),
              f"sweep_rows_block_gs {tag} at block 1, both paths: bitwise "
              f"sweep_rows_gs ({PREFIX} picks)")

    # Beyond the main shapes; the plans of the main path.
    width = csr[None].padded_rows()[0].shape[1]
    for blk, want in ((8, (8, 32, 8)), (128, (8, 2, 128))):
        plan = sweep_csr.block_plan(n, width, blk, 4, 4, cap)
        check(plan.shared and (plan.warps, plan.lanes, plan.tile_rows) == want,
              f"sweep_rows_block_gs block {blk} plan on the card: x in "
              "shared memory, (warps, lanes, tile rows) == "
              f"{want} ({plan})")
    vals, cols = csr["bfloat16"].padded_rows()
    odd = 2 * torch.randint(0, n // 30 // 2, (64,), generator=gen,
                            device=dev) + 1
    held("bf16/i16, odd panel ids (unaligned bulk copies)", vals, cols,
         spd.b, x0, odd, 30)
    vals, cols = csr[None].padded_rows()
    for blk, steps in ((8, 128), (128, 16)):
        twice = torch.randint(0, n // blk, (steps,), generator=gen,
                              device=dev).repeat_interleave(2)
        held("f32/i32, each panel twice in a row", vals, cols, spd.b, x0,
             twice, blk)
    wide = random_sparse_spd(n, row_nnz=CSR_BGS_WIDE_NNZ, n_rhs=K,
                             seed=CSR_BGS_SEED, device=dev)
    wvals, wcols = as_operator(wide.A, "csr").padded_rows()
    del wide
    check(wvals.shape[1] > 64, f"random_sparse_spd({n}, row_nnz="
          f"{CSR_BGS_WIDE_NNZ}) has rows wider than 64 slots "
          f"({wvals.shape[1]})")
    for blk, steps in ((8, 128), (128, 16)):
        picks = torch.randint(0, n // blk, (steps,), generator=gen,
                              device=dev)
        held(f"f32/i32, rows of {wvals.shape[1]} slots", wvals, wcols, spd.b,
             x0, picks, blk)
    del wvals, wcols
    m, width = CSR_BGS_NORING
    nvals = torch.randn((m, width), generator=gen, device=dev) / width
    ncols = torch.randint(0, m, (m, width), generator=gen, device=dev,
                          dtype=torch.int32)
    plan = sweep_csr.block_plan(m, width, 128, 4, 4, cap)
    check(plan.tile_rows == 0 and plan.shared, f"rows of {width} slots "
          f"take the first design, x in shared memory ({plan})")
    picks = torch.randint(0, m // 128, (4,), generator=gen, device=dev)
    held(f"f32/i32, rows of {width} slots (the first design)", nvals, ncols,
         spd.b[:m].contiguous(), x0[:m].contiguous(), picks, 128)
    del nvals, ncols

    sched = {blk: Schedule(num_iters=CSR_BGS_SWEEPS * (n // blk),
                           record_every=n // blk) for blk in CSR_BGS_BLOCKS}
    expect = dict(sweep_rows_block_gs=CSR_BGS_SWEEPS,
                  spmv_csr_sliced=2 * CSR_BGS_SWEEPS,
                  colsum=2 * CSR_BGS_SWEEPS)
    runs = [(blk, None) for blk in CSR_BGS_BLOCKS]
    runs.append((CSR_BGS_BLOCKS[-1], "bfloat16"))
    solves = {}
    for blk, sd in runs:
        kw = dict(format="csr", gs_block=blk, storage_dtype=sd,
                  generator=torch.Generator(dev).manual_seed(CSR_BGS_SEED),
                  schedule=sched[blk])
        tag = (f"CSR block GS (gs_block {blk}"
               + ("" if sd is None else ", bf16 storage")
               + f"), {CSR_BGS_SWEEPS} sweeps")
        res = drive(tag, expect, functools.partial(solve, spd, **kw))
        solves[tag] = (res, kw)
        check(res.x.shape == (n, K) and bool(torch.isfinite(res.x).all())
              and bool((res.resid[-1] < res.resid[0]).all()),
              f"{tag}: iterate finite, the residual falls at every column "
              "(column 0: " + ", ".join(f"{v:.4g}" for v in
                                        res.resid[:, 0].tolist()) + ")")
        # bf16 storage solves the rounded system, whose solution is not
        # x_star: its err_sq stops falling near the rounding's distance
        A = spd.A if sd is None else spd.A.to(torch.bfloat16).float()
        if sd is None:
            seq = torch.cat([a_norm_sq(spd.A, spd.x_star)[None, :],
                             res.err_sq], 0).double()
            worst = float((seq[1:] / seq[:-1]).max())
            check(worst <= 1 + MONO_RTOL, f"{tag}: A-norm err_sq "
                  "non-increasing (largest ratio of consecutive records "
                  f"{worst:.6f})")
        want = torch.linalg.vector_norm(spd.b - A @ res.x, dim=0)
        e = float(((res.resid[-1] - want).abs() / want).max())
        check(e <= RESID_RTOL, f"{tag}: final residual vs dense "
              f"torch.matmul, max rel diff {e:.3e} <= {RESID_RTOL:g}")

    # Serving chunks of one sweep each, chained over one stream: bitwise
    # the one-shot solve; one sweep, one matvec and one colsum a chunk.
    op = csr[None]
    blk = CSR_BGS_BLOCKS[-1]
    rec = n // blk
    picks = torch.randint(0, rec, (SERVE_CHAIN * rec,), generator=gen,
                          device=dev, dtype=torch.int32)

    def chained():
        x = torch.zeros_like(spd.b)
        for c in range(SERVE_CHAIN):
            x, _ = sequential_chunk(op, spd.b, x, picks[c * rec:(c + 1) * rec],
                                    action="gs", block=blk)
        return x
    x = drive(f"CSR block GS (gs_block {blk}): {SERVE_CHAIN} serving chunks "
              "chained", dict(sweep_rows_block_gs=SERVE_CHAIN,
                              spmv_csr_sliced=SERVE_CHAIN,
                              colsum=SERVE_CHAIN), chained)
    once = solve_sequential(op, spd.b, torch.zeros_like(spd.b), spd.x_star,
                            action="gs", num_iters=SERVE_CHAIN * rec,
                            picks=picks, block=blk, record_every=rec)
    check(torch.equal(x, once.x), f"CSR block GS (gs_block {blk}): "
          f"{SERVE_CHAIN} chained serving chunks bitwise solve_sequential")

    # A main-path chunk (a sweep: n // blk picks) at each block, from
    # Python and from a CUDA graph, and by path in turns (shared, global,
    # global, shared).
    vals, cols = op.padded_rows()
    chunks = {}
    for blk in CSR_BGS_BLOCKS:
        picks = torch.randint(0, n // blk, (n // blk,), generator=gen,
                              device=dev)
        run = functools.partial(ops.sweep_rows_block_gs, vals, cols, spd.b,
                                x0, picks, block=blk)
        ms, g_ms = cuda_ms(run, 5), graph_ms(run, 5)
        p32 = picks.to(torch.int32)
        turns = [cuda_ms(functools.partial(
            sweep_csr.sweep_rows_block_gs, vals, cols, spd.b, x0, p32,
            block=blk, beta=1.0, limit=n // blk, _shared=shared), 5)
            for shared in (True, False, False, True)]
        chunks[blk] = dict(picks=picks, run=run, ms=ms, graph_ms=g_ms,
                           turns=turns)
        full = [sweep_csr.sweep_rows_block_gs(
            vals, cols, spd.b, x0, p32, block=blk, beta=1.0, limit=n // blk,
            _shared=shared) for shared in (False, True)]
        want = ref.sweep_rows_block_gs_ref(vals, cols, spd.b, x0, picks,
                                           block=blk)
        e = rel(full[0], want)
        check(e <= SWEEP_RTOL and torch.equal(*full),
              f"sweep_rows_block_gs block {blk}, a main-path chunk ({n // blk}"
              f" picks) on the global path: rel err {e:.3e} <= "
              f"{SWEEP_RTOL:g} and bitwise the shared-memory path")
        print(f"  sweep_rows_block_gs, one main-path chunk (block {blk}, "
              f"{n // blk} picks, n={n}, k={K}): {ms:.4f} ms from Python, "
              f"{g_ms:.4f} ms from a graph ({g_ms * 1e3 / (n // blk):.3f} "
              "us/pick); by path in turns (shared, global, global, shared) "
              + "/".join(f"{t:.4f}" for t in turns) + f" ms [{smi}]",
              flush=True)
    return solves, dict(errs=errs, chunks=chunks, op=op, x0=x0)

def paper_phase(torch, ops, spd, lsq, launches, smi: str) -> None:
    """The paper's figure and theorem drivers (``repro_torch.paper``) and
    the two examples (``repro_torch.examples``) on the card through their
    entry points, each with the launch counters set to 0 just before it
    and read just after: the dense solves launch ``colsum`` (records, CG's
    dots) and fig2's P = 1 rounds ``block_gs_sweep`` (the ranks it spawns
    count their own).  Then one sweep of the main path on CSR, GS and RK
    (the sweep and its record), driven through ``solve`` with its launches
    counted exactly, and timed from a CUDA graph against
    ``roofline.sweep_roofline``.  Every driven path's launches go into
    ``launches``."""
    import contextlib
    import io

    import numpy as np

    from repro_torch import DenseOp, Schedule, as_operator, roofline, solve
    from repro_torch.core.engine import draw_picks, record_metrics, sweep
    from repro_torch.examples import quickstart, solve_regression
    from repro_torch.paper import (fig1_residual, fig2_scaling,
                                   fig3_async_penalty, theory_validation)

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)

    def driven(tag, kernels, run):
        """``run()`` with its printed lines kept (printed after it,
        prefixed); it must launch each of ``kernels`` and no other."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        for line in buf.getvalue().splitlines():
            print(f"    [{tag}] {line}", flush=True)
        ran = {name: n for name, n in got.items() if n}
        check(set(ran) == set(kernels), f"{tag}: launched {sorted(kernels)} "
              f"and no other kernel ({ran}); {wall:.2f} s wall [{smi}]")
        for name, n in got.items():
            launches[name] += n
        return out

    def measured(driver):
        out = driver.measure()
        driver.report(out)
        return out

    def falls(resid):
        """Relative residual norms by record, each at most the last."""
        norms = torch.linalg.vector_norm(resid.double(), dim=1).cpu()
        return (bool(torch.isfinite(norms).all())
                and bool((norms[1:] <= norms[:-1] * (1 + MONO_RTOL)).all()))

    tv = driven("theory_validation", {"colsum"},
                lambda: measured(theory_validation))
    ll, t41, t61 = tv["ll"], tv["thm41a"], tv["thm61"]
    check(ll["satisfied"] == 1, f"theory_validation: the Leventhal-Lewis "
          f"rate holds (measured E_m {ll['measured_mean']:.4e} <= 1.5 x "
          f"bound {ll['bound']:.4e})")
    check(t41["satisfied"] == 1, f"theory_validation: Thm 4.1(a) holds "
          f"(measured {t41['measured']:.5f} <= 1.2 x factor "
          f"{t41['factor_bound']:.5f})")
    check(t61["converged"] == 1, f"theory_validation: Thm 6.1 converges "
          f"(E_8n / E_0 {t61['err_ratio_8n']:.3e} < 0.05)")

    rgs_r, cg_r = driven("fig1_residual", {"colsum"}, fig1_residual.run)
    check(bool(np.isfinite(rgs_r).all() and (np.diff(rgs_r) <= 0).all()),
          f"fig1_residual: the RGS residual falls by sweep ({rgs_r[0]:.3e} "
          f"to {rgs_r[-1]:.3e})")
    print(f"  fig1_residual: CG residual monotone "
          f"{int(bool(np.all(np.diff(cg_r) < 0)))} (printed, not checked: "
          f"at the f32 floor, {cg_r[-1]:.2e} of ||b||, one ulp can tick it "
          "up)", flush=True)

    f3 = driven("fig3_async_penalty", {"colsum"},
                lambda: measured(fig3_async_penalty))
    for row in f3["rows"]:
        if row["model"] == "consistent":
            check(row["penalty"] <= PAPER_PENALTY_MAX,
                  f"fig3_async_penalty: consistent reads at tau "
                  f"{row['tau']} cost {row['penalty']:.3f}x the sync "
                  f"residual <= {PAPER_PENALTY_MAX}x")

    f2 = driven("fig2_scaling", {"block_gs_sweep", "colsum"},
                lambda: fig2_scaling.run(PAPER_FIG2_N,
                                         workers=PAPER_WORKERS))
    check([rec["P"] for rec in f2] == list(PAPER_WORKERS),
          f"fig2_scaling: a record at every worker count {PAPER_WORKERS}")
    for rec in f2:
        local = PAPER_FIG2_N // rec["P"]
        check(rec["tau"] == (rec["P"] - 1) * local and rec["x_finite"]
              and rec["iters_per_worker"] == 10 * local,
              f"fig2_scaling P = {rec['P']}: tau {rec['tau']} = (P - 1) n / "
              f"P, x finite on every rank, resid {rec['resid']:.3e}, "
              f"{rec['wall_s']:.2f} s wall, all-gather "
              f"{rec['ring_wire_bytes']:.0f} B a rank and round")
    check(f2[0]["resid"] <= PAPER_P1_RESID, f"fig2_scaling: the residual "
          f"falls 50-fold at P = 1 ({f2[0]['resid']:.3e} <= "
          f"{PAPER_P1_RESID:g})")

    # The card's streams on the CPU: fig3's and fig2's problem (its matrix
    # built on the host, b and x* on the card), fig3's default streams at
    # its largest tau as the card draws them (fig3_async_penalty.streams),
    # and fig2's P = 1 stream as the card's rank 0 draws it (seed 0 * P +
    # rank).  Not counted: these runs compare, they drive nothing.
    cpu = torch.device("cpu")
    prob = fig3_async_penalty.default_problem(PAPER_FIG2_N, dev)
    prob = prob._replace(**{f: getattr(prob, f).to(cpu)
                            for f in prob._fields})
    tau = fig3_async_penalty.TAUS[-1]
    picks, delays = fig3_async_penalty.streams(
        prob.n, fig3_async_penalty.SWEEPS * prob.n, (tau,),
        fig3_async_penalty.TRIALS, dev)
    t0 = time.perf_counter()
    rep3 = fig3_async_penalty.measure(
        taus=(tau,), problem=prob, picks=picks.to(cpu),
        delays={key: [d.to(cpu) for d in ds] for key, ds in delays.items()})
    card3 = [row for row in f3["rows"] if row["tau"] == tau]
    pairs = [(f3["sync"], rep3["sync"])] + [
        pair for c, h in zip(card3, rep3["rows"])
        for pair in zip(c["resids"], h["resids"])]
    err = max(abs(h / c - 1) for c, h in pairs)
    check(len(pairs) == 1 + 2 * fig3_async_penalty.TRIALS
          and err <= PAPER_REPLAY_RTOL,
          f"fig3_async_penalty on the CPU with the card's streams at tau "
          f"{tau}: the sync and every trial's residual within rel "
          f"{err:.2e} <= {PAPER_REPLAY_RTOL:g} of the card's; consistent "
          f"penalty {rep3['rows'][0]['penalty']:.3f}x on the CPU, "
          f"{card3[0]['penalty']:.3f}x on the card "
          f"({time.perf_counter() - t0:.2f} s)")
    rounds = f2[0]["sync_rounds"]
    p1 = torch.randint(0, PAPER_FIG2_N, (rounds, 1, PAPER_FIG2_N),
                       generator=torch.Generator(dev).manual_seed(0),
                       device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        rep2 = fig2_scaling.run(PAPER_FIG2_N, rounds, (1,), problem=prob,
                                picks={1: p1.to(cpu)})
    err = abs(rep2[0]["resid"] / f2[0]["resid"] - 1)
    check(err <= PAPER_REPLAY_RTOL, f"fig2_scaling at P = 1 on the CPU with "
          f"the card's stream: residual {rep2[0]['resid']:.4e} within rel "
          f"{err:.2e} <= {PAPER_REPLAY_RTOL:g} of the card's "
          f"{f2[0]['resid']:.4e}")

    qs = driven("quickstart", {"colsum"}, lambda: quickstart.main([]))
    check(falls(qs["sync"].resid), "quickstart: the sync RGS residual "
          "falls by sweep")
    reg = driven("solve_regression", {"colsum"},
                 lambda: solve_regression.main([]))
    check(falls(reg["sync"].resid), "solve_regression: the sync RK "
          "residual falls by sweep")

    # The dense coordinate sweeps these drivers run (DenseOp.gs_sweep and
    # rk_sweep: a few PyTorch calls a pick, no kernel, as the reference's
    # lax.scan has none), on the host clock at the drivers' shapes: fig2's
    # n with 4 columns, and solve_regression's X with 51.
    gen = torch.Generator(dev).manual_seed(SEED + 62)
    X, Y, _ = (torch.from_numpy(a).to(dev)
               for a in solve_regression.build_problem())
    gs_op = DenseOp(torch.eye(PAPER_FIG2_N, device=dev))
    rk_op = DenseOp(X)
    rn = rk_op.row_norms_sq()
    for tag, op, b, step in (
            ("gs_sweep", gs_op, torch.ones((PAPER_FIG2_N, 4), device=dev),
             lambda b, x, p: gs_op.gs_sweep(b, x, p)),
            ("rk_sweep", rk_op, Y,
             lambda b, x, p: rk_op.rk_sweep(b, rn, x, p))):
        m, n = op.shape
        k = b.shape[1]
        x = torch.zeros((n, k), device=dev)
        picks = torch.randint(0, m, (PAPER_DENSE_PICKS,), generator=gen,
                              device=dev)
        step(b, x, picks[:8])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b, x, picks)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) * 1e6 / PAPER_DENSE_PICKS
        print(f"  DenseOp.{tag} on {m}x{n}, k={k}: {us:.2f} us a pick on the "
              f"host clock ({PAPER_DENSE_PICKS} picks; no kernel) [{smi}]",
              flush=True)
    del X, Y, gs_op, rk_op

    print(f"== time per sweep against its roofline (CSR, k={K}: a sweep and "
          "its record)", flush=True)
    gen = torch.Generator(dev).manual_seed(SEED + 61)
    card = torch.cuda.get_device_name(0)
    for action, prob, kernel in (("gs", spd, "sweep_rows_gs"),
                                 ("rk", lsq, "sweep_rows_rk")):
        op = as_operator(prob.A, "csr")
        m, n = op.shape
        picks = draw_picks(op, action, m, generator=gen).to(
            torch.int32).contiguous()
        matvecs = 2 if action == "gs" else 1
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        solve(prob, format="csr", picks=picks,
              schedule=Schedule(num_iters=m, record_every=m))
        torch.cuda.synchronize()
        got = ops.launch_counts()
        mv = got["spmv_csr_sliced"] + got["spmv_csr_sliced_prefetch"]
        check(got[kernel] == 1 and got["colsum"] == 2 and mv == matvecs
              and sum(got.values()) == 3 + matvecs,
              f"one CSR {action.upper()} sweep through solve: one {kernel}, "
              f"{matvecs} sliced matvec(s), two colsum and nothing else "
              f"({ {k: v for k, v in got.items() if v} })")
        for name, c in got.items():
            launches[name] += c
        x0 = torch.zeros_like(prob.x_star)
        rn = op.row_norms_sq() if action == "rk" else None
        norm = "A" if action == "gs" else "euclid"

        def chunk(op=op, prob=prob, picks=picks, x0=x0, rn=rn, norm=norm,
                  action=action):
            x = sweep(op, prob.b, x0, picks, action=action, beta=1.0,
                      block=1, rn=rn)
            return record_metrics(op, prob.b, x, prob.x_star, norm=norm)

        ms = graph_ms(chunk, PAPER_GRAPH_CALLS)
        vals, cols = op.padded_rows()
        roof = roofline.sweep_roofline(
            action, picked_nnz=float(op.row_nnz[picks.long()].double().sum()),
            picks=m, nnz=op.nnz, m=m, n=n, k=K,
            counts=op.stop_counts(K) is not None, device_name=card,
            value_dtype=vals.dtype, index_dtype=cols.dtype)
        share = roof.share(ms)
        check(0.0 < share <= 1.0, f"CSR {action.upper()}: a sweep's roofline "
              f"share {share:.3e} in (0, 1]")
        print(f"  time per sweep against its roofline, CSR {action.upper()} "
              f"({m}x{n}, {m} picks and one record, k={K}): {ms:.4f} ms "
              f"from a CUDA graph; roofline {roof.ms:.5f} ms "
              f"({roof.bound_by}; sweep {roof.sweep.bytes:.0f} B and "
              f"{roof.sweep.flops:.0f} flops, record {roof.record.bytes:.0f} "
              f"B and {roof.record.flops:.0f} flops); share {share:.3e} "
              f"[{smi}]", flush=True)
    print(f"  the paper's phase: {time.perf_counter() - t_phase:.1f} s wall",
          flush=True)


def main() -> int:
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    # The paths below run the untuned defaults, which a
    # TUNE_torch_cuda.json at the root of the checkout would steer (matvec
    # variant, rows_per_panel).  Table lookups are off in this process and
    # its children; the tuned phase installs its own table.
    os.environ["REPRO_TORCH_TUNE_TABLE"] = "off"
    try:
        from repro_torch import (Schedule, a_norm_sq, as_operator,
                                 block_banded_spd, laplacian_spd,
                                 random_sparse_lsq, random_sparse_spd,
                                 roofline, solve)
        from repro_torch.core import ell_from_dense
        from repro_torch.core import partition, theory
        from repro_torch.core.distributed import (_a2a_plan,
                                                  _sync_bytes_per_round)
        from repro_torch.core.engine import (draw_picks, record_metrics,
                                             sample_rows, scheduled_tau)
        from repro_torch.core.operators import (DENSE_MATVEC_COLUMNS,
                                                CsrOp, DenseOp)
        from repro_torch.kernels import (_build, ops, ref, ref_banded,
                                         sweep_csr)
        from repro_torch.kernels import banded_gs as _banded
        from repro_torch.kernels import bbmv as _bbmv
        from repro_torch.kernels import spmv_csr as _spmv
        from repro_torch.kernels import block_gs as _block_gs
        from repro_torch.launch.mesh import process_group, run_workers
        from repro_torch.tune import TuningTable, runtime, use_table
        from repro_torch.tune.table import MATVEC_VARIANTS
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = nvidia_smi()
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    print("== build", flush=True)
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # A pick id out of range stops a sweep kernel with a device-side
    # assert (it would otherwise read and write out of bounds).  The assert
    # leaves its CUDA context unusable, so each probe runs in a child
    # process, both started together before this process touches the card.
    head = ("import sys, torch; sys.path.insert(0, 'src')\n"
            "from repro_torch.kernels import ops\n")
    probes = {
        "sweep_rows_gs with pick 4 of 4 rows": head + (
            "v = torch.ones((4, 2), device='cuda')\n"
            "c = torch.zeros((4, 2), dtype=torch.int32, device='cuda')\n"
            "x = torch.zeros((4, 1), device='cuda')\n"
            "ops.sweep_rows_gs(v, c, x, x, torch.tensor([1, 4], "
            "device='cuda'))\n"
            "torch.cuda.synchronize()\n"),
        "banded_gs_sweep with block row 2 of 2": head + (
            "t = torch.zeros((2, 3, 4, 4), device='cuda')\n"
            "b = torch.zeros((8, 1), device='cuda')\n"
            "xw = torch.zeros((16, 1), device='cuda')\n"
            "ops.banded_gs_sweep(t, b, xw, torch.tensor([0, 2], "
            "device='cuda'), block=4, bands=1)\n"
            "torch.cuda.synchronize()\n"),
        "block_gs_sweep with block 2 of 2": head + (
            "A = torch.eye(8, device='cuda')\n"
            "b = torch.zeros((8, 1), device='cuda')\n"
            "ops.block_gs_sweep(A, b, b, torch.tensor([1, 2], "
            "device='cuda'), block=4)\n"
            "torch.cuda.synchronize()\n"),
        "sweep_rows_block_gs with panel 2 of 2": head + (
            "v = torch.ones((8, 2), device='cuda')\n"
            "c = torch.zeros((8, 2), dtype=torch.int32, device='cuda')\n"
            "x = torch.zeros((8, 1), device='cuda')\n"
            "ops.sweep_rows_block_gs(v, c, x, x, torch.tensor([1, 2], "
            "device='cuda'), block=4)\n"
            "torch.cuda.synchronize()\n")}
    children = {what: subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for what, code in probes.items()}
    outs = {}
    try:
        for what, proc in children.items():
            outs[what] = proc.communicate(timeout=300)[0]
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for what, proc in children.items():
        out = outs[what]
        said = [ln.strip() for ln in out.splitlines()
                if "r >= 0 && r < limit" in ln
                or "device-side assert triggered" in ln]
        check(proc.returncode != 0
              and any("device-side assert triggered" in ln for ln in said),
              f"{what} stops at its device-side assert (child exit "
              f"{proc.returncode}): " + " | ".join(ln[-100:]
                                                   for ln in said[:2]))
    print(f"  torch.cuda.get_device_name(0)={torch.cuda.get_device_name(0)}",
          flush=True)

    print("== problems", flush=True)
    t0 = time.perf_counter()
    spd = random_sparse_spd(SPD_N, row_nnz=SPD_ROW_NNZ, n_rhs=K, seed=SEED)
    torch.cuda.synchronize()
    print(f"  random_sparse_spd({SPD_N}, row_nnz={SPD_ROW_NNZ}, n_rhs={K}): "
          f"{time.perf_counter() - t0:.2f} s, lam=[{float(spd.lam_min):.4f}, "
          f"{float(spd.lam_max):.4f}]", flush=True)
    t0 = time.perf_counter()
    lsq = random_sparse_lsq(LSQ_M, LSQ_N, row_nnz=LSQ_ROW_NNZ, n_rhs=K,
                            seed=SEED)
    torch.cuda.synchronize()
    print(f"  random_sparse_lsq({LSQ_M}, {LSQ_N}, row_nnz={LSQ_ROW_NNZ}, "
          f"n_rhs={K}): {time.perf_counter() - t0:.2f} s, sigma=["
          f"{float(lsq.sigma_min):.4f}, {float(lsq.sigma_max):.4f}]",
          flush=True)
    t0 = time.perf_counter()
    banded = block_banded_spd(SPD_N, block=BLOCK, bands=BANDS, n_rhs=K,
                              seed=SEED)
    torch.cuda.synchronize()
    print(f"  block_banded_spd({SPD_N}, block={BLOCK}, bands={BANDS}, "
          f"n_rhs={K}): {time.perf_counter() - t0:.2f} s, lam=["
          f"{float(banded.lam_min):.4f}, {float(banded.lam_max):.4f}]",
          flush=True)
    # The same design with every 16th panel of 8 rows zeroed (rows with no
    # features): its CSR pattern has empty panels, so its matvec takes the
    # predicated kernel.  Zero rows of A have zero rows of b = A x_true.
    A_holes = lsq.A.clone()
    b_holes = lsq.b.clone()
    A_holes.view(-1, 8, LSQ_N)[::16] = 0.0
    b_holes.view(-1, 8, K)[::16] = 0.0
    s = torch.linalg.svdvals(A_holes)
    lsq_holes = lsq._replace(A=A_holes, b=b_holes, sigma_min=s[-1],
                             sigma_max=s[0])

    gen = torch.Generator(dev).manual_seed(SEED + 7)
    ops_by = {}
    for key, A in ((("spd", None), spd.A), (("lsq", None), lsq.A),
                   (("spd", "bfloat16"), spd.A), (("lsq", "bfloat16"), lsq.A),
                   (("holes", None), lsq_holes.A)):
        t0 = time.perf_counter()
        op = ops_by[key] = as_operator(A, "csr", storage_dtype=key[1])
        torch.cuda.synchronize()
        print(f"  csr {key}: built from dense in "
              f"{time.perf_counter() - t0:.3f} s; shape={op.shape} "
              f"nnz={op.nnz} row_cap={op.row_cap} values={op.data.dtype} "
              f"indices={op.indices.dtype} empty panels="
              f"{int((op.panel_nnz() == 0).sum())}", flush=True)
    for sd in (None, "bfloat16"):
        t0 = time.perf_counter()
        op = ops_by[("ell", sd)] = as_operator(spd.A, "ell", storage_dtype=sd)
        torch.cuda.synchronize()
        print(f"  ell {sd}: built from dense in {time.perf_counter() - t0:.3f}"
              f" s; vals {tuple(op.vals.shape)} {op.vals.dtype}, cols "
              f"{op.cols.dtype}", flush=True)
        t0 = time.perf_counter()
        op = ops_by[("banded", sd)] = as_operator(
            banded.A, "banded", block=BLOCK, bands=BANDS, storage_dtype=sd)
        torch.cuda.synchronize()
        print(f"  banded {sd}: built from dense in "
              f"{time.perf_counter() - t0:.3f} s; tiles "
              f"{tuple(op.A_bands.shape)} {op.A_bands.dtype}", flush=True)
    ell = ops_by[("ell", None)]
    ell_width = ell.width
    check(int((ell.vals != 0).sum()) == ops_by[("spd", None)].nnz,
          f"ELL at width {ell_width} holds every nonzero of the SPD problem "
          f"({ops_by[('spd', None)].nnz})")
    check(torch.equal(ops_by[("banded", None)].to_dense(), banded.A),
          "the band tiles reconstruct the block-banded matrix exactly")
    # The CSR build on the card against the CPU's, on the main SPD
    # operator, the empty-panel design and a ragged bf16/int16 operator.
    from repro_torch.tune.spmv_probe import ragged_dense
    A_ragged = ragged_dense(RW_M, RW_N, torch.Generator(dev).manual_seed(
        SEED + 29), dev, RW_WIDE)
    t0 = time.perf_counter()
    ragged_bf16 = CsrOp.from_dense(A_ragged, storage_dtype="bfloat16")
    torch.cuda.synchronize()
    print(f"  csr ragged {RW_M}x{RW_N} bf16: built from dense in "
          f"{time.perf_counter() - t0:.3f} s; nnz={ragged_bf16.nnz} "
          f"indices={ragged_bf16.indices.dtype}", flush=True)
    csr_built_on_card(torch, {
        f"SPD {SPD_N}": (spd.A, ops_by[("spd", None)], None),
        f"empty-panel LSQ {LSQ_M}x{LSQ_N}": (lsq_holes.A,
                                            ops_by[("holes", None)], None),
        f"ragged {RW_M}x{RW_N} bf16/i16": (A_ragged, ragged_bf16,
                                          "bfloat16")})
    del A_ragged, ragged_bf16

    print("== kernels against their plain versions", flush=True)
    errs = {}
    x_spd = torch.randn((SPD_N, K), generator=gen, device=dev)
    x_lsq = torch.randn((LSQ_N, K), generator=gen, device=dev)
    gs_picks = torch.randint(0, SPD_N, (PREFIX,), generator=gen, device=dev)
    rk_picks = {sd: sample_rows(ops_by[("lsq", sd)].row_norms_sq(), PREFIX,
                                generator=gen) for sd in (None, "bfloat16")}

    def csr_matvec(op, x, variant):
        """A CSR matvec variant's kernel name, its wrapper's call and its
        plain version's call on ``op``'s arrays and ``x``: the sliced pair
        reads the sliced-ELL windows, the segment-sum pair the flat
        panel-aligned layout."""
        m, R, W = op.shape[0], op.rows_per_panel, op.panel_width
        vals, cols = op.sliced_rows()
        flat = (op.data, op.indices, op.row_id)
        seg = dict(m=m, rows_per_panel=R, panel_width=W)
        rows = op.segsum_rows()
        pn = op.panel_nnz()
        return {
            "sliced": (
                "spmv_csr_sliced",
                lambda: ops.spmv_csr_sliced(vals, cols, x, m=m,
                                            rows_per_panel=R,
                                            counts=op.stop_counts(
                                                x.shape[1])),
                lambda: ref.spmv_csr_sliced_ref(vals, cols, x, m=m)),
            "sliced_prefetch": (
                "spmv_csr_sliced_prefetch",
                lambda: ops.spmv_csr_sliced_prefetch(
                    vals, cols, pn, x, m=m, rows_per_panel=R,
                    counts=op.stop_counts(x.shape[1])),
                lambda: ref.spmv_csr_sliced_prefetch_ref(
                    vals, cols, pn, x, m=m, rows_per_panel=R)),
            "segsum": (
                "spmv_csr",
                lambda: ops.spmv_csr(*flat, x, **seg, **rows),
                lambda: ref.spmv_csr_segsum_ref(*flat, x, **seg)),
            "segsum_prefetch": (
                "spmv_csr_prefetch",
                lambda: ops.spmv_csr_prefetch(*flat, pn, x, **seg, **rows),
                lambda: ref.spmv_csr_segsum_prefetch_ref(*flat, pn, x,
                                                         **seg)),
        }[variant]

    def matvec_scale(op, x):
        """|A| |x|, the scale of the matvec tolerance."""
        vals, cols = op.sliced_rows()
        return ref.spmv_csr_sliced_ref(vals.abs(), cols, x.abs(),
                                       m=op.shape[0])

    def spmv_check(tag, op, x, variant):
        """A CSR matvec kernel against its plain version, within the
        matvec tolerance."""
        name, run, plain = csr_matvec(op, x, variant)
        y, want = run(), plain()
        torch.cuda.synchronize()
        err = (y - want).abs()
        check(bool((err <= SPMV_RTOL * matvec_scale(op, x)
                    + SPMV_ATOL).all()),
              f"{name} {tag}: max|kernel - plain| = {float(err.max()):.3e} "
              f"within {SPMV_RTOL:g}*(|A||x|) + {SPMV_ATOL:g}")
        return y, float(err.max())

    for sd in (None, "bfloat16"):
        tag = "f32/i32" if sd is None else "bf16/i16"
        op = ops_by[("spd", sd)]
        vals, cols = op.padded_rows()
        got = ops.sweep_rows_gs(vals, cols, spd.b, x_spd, gs_picks, beta=0.9)
        want = ref.sweep_rows_gs_ref(vals, cols, spd.b, x_spd, gs_picks,
                                     beta=0.9)
        torch.cuda.synchronize()
        e = rel(got, want)
        check(e <= SWEEP_RTOL, f"sweep_rows_gs {tag} n={SPD_N} k={K} "
              f"{PREFIX} picks: rel err {e:.3e} <= {SWEEP_RTOL:g}")
        errs[("sweep_rows_gs", sd)] = float((got - want).abs().max())
        one = ops.sweep_rows_gs(vals, cols, spd.b[:, :1].contiguous(),
                                x_spd[:, :1].contiguous(), gs_picks, beta=0.9)
        check(torch.equal(one[:, 0], got[:, 0]),
              f"sweep_rows_gs {tag}: column 0 at k={K} bitwise equals k=1")

        op = ops_by[("lsq", sd)]
        vals, cols = op.padded_rows()
        rn = op.row_norms_sq()
        got = ops.sweep_rows_rk(vals, cols, lsq.b, rn, x_lsq, rk_picks[sd],
                                beta=0.9)
        want = ref.sweep_rows_rk_ref(vals, cols, lsq.b, rn, x_lsq,
                                     rk_picks[sd], beta=0.9)
        torch.cuda.synchronize()
        e = rel(got, want)
        check(e <= SWEEP_RTOL, f"sweep_rows_rk {tag} {LSQ_M}x{LSQ_N} k={K} "
              f"{PREFIX} picks: rel err {e:.3e} <= {SWEEP_RTOL:g}")
        errs[("sweep_rows_rk", sd)] = float((got - want).abs().max())
        one = ops.sweep_rows_rk(vals, cols, lsq.b[:, :1].contiguous(), rn,
                                x_lsq[:, :1].contiguous(), rk_picks[sd],
                                beta=0.9)
        check(torch.equal(one[:, 0], got[:, 0]),
              f"sweep_rows_rk {tag}: column 0 at k={K} bitwise equals k=1")

        for name, key, x in (("spd", ("spd", sd), x_spd),
                             ("lsq", ("lsq", sd), x_lsq)):
            y_sl, errs[("spmv_csr_sliced", sd, name)] = spmv_check(
                f"{tag} {name}", ops_by[key], x, "sliced")
            y_slp, errs[("spmv_csr_sliced_prefetch", sd, name)] = spmv_check(
                f"{tag} {name}", ops_by[key], x, "sliced_prefetch")
            check(torch.equal(y_sl, y_slp), "spmv_csr_sliced == "
                  f"spmv_csr_sliced_prefetch bitwise, {tag} {name}")
            y_seg, errs[("spmv_csr", sd, name)] = spmv_check(
                f"{tag} {name}", ops_by[key], x, "segsum")
            y_pre, errs[("spmv_csr_prefetch", sd, name)] = spmv_check(
                f"{tag} {name}", ops_by[key], x, "segsum_prefetch")
            check(torch.equal(y_seg, y_pre), f"spmv_csr == spmv_csr_prefetch "
                  f"bitwise, {tag} {name}")

    holes = ops_by[("holes", None)]
    y_plain, _ = spmv_check("f32/i32 empty panels", holes, x_lsq, "sliced")
    y_pred, errs["prefetch_holes"] = spmv_check(
        "f32/i32 empty panels", holes, x_lsq, "sliced_prefetch")
    check(torch.equal(y_plain, y_pred),
          "spmv_csr_sliced == spmv_csr_sliced_prefetch bitwise on a pattern "
          f"with {int((holes.panel_nnz() == 0).sum())} empty panels")
    y_seg, errs[("spmv_csr", None, "holes")] = spmv_check(
        "f32/i32 empty panels", holes, x_lsq, "segsum")
    y_segp, errs[("spmv_csr_prefetch", None, "holes")] = spmv_check(
        "f32/i32 empty panels", holes, x_lsq, "segsum_prefetch")
    check(torch.equal(y_seg, y_segp),
          "spmv_csr == spmv_csr_prefetch bitwise on a pattern with "
          f"{int((holes.panel_nnz() == 0).sum())} empty panels")
    # the two matvec families add the same nonzero terms in the same order
    print("  segment sum against sliced on the empty-panel design: bitwise "
          f"{'equal' if torch.equal(y_seg, y_plain) else 'different'} "
          f"(max |diff| {float((y_seg - y_plain).abs().max()):.3e})",
          flush=True)
    for tag, op, x in (("SPD", ops_by[("spd", None)], x_spd),
                       ("empty panels", holes, x_lsq)):
        kw = dict(m=op.shape[0], rows_per_panel=op.rows_per_panel,
                  panel_width=op.panel_width, **op.segsum_rows())
        x1 = x[:, :1].contiguous()
        args = (op.data, op.indices, op.row_id)
        for name, full, one in (
                ("spmv_csr", ops.spmv_csr(*args, x, **kw),
                 ops.spmv_csr(*args, x1, **kw)),
                ("spmv_csr_prefetch",
                 ops.spmv_csr_prefetch(*args, op.panel_nnz(), x, **kw),
                 ops.spmv_csr_prefetch(*args, op.panel_nnz(), x1, **kw))):
            check(torch.equal(one[:, 0], full[:, 0]),
                  f"{name} {tag}: column 0 at k={K} bitwise equals k=1")

    # bf16 values with int32 indices: a square operator with n > 32767,
    # five distinct columns per row (the diagonal and four offsets)
    n_big = 40000
    offs = torch.tensor([0, 1, 977, 20011, 39999], device=dev)
    rows = torch.arange(n_big, device=dev)
    row_cols = ((rows[:, None] + offs[None, :]) % n_big).to(torch.int32)
    row_vals = (torch.randn((n_big, 5), generator=gen, device=dev) * 0.2)
    row_vals[:, 0] = 1.0
    big = CsrOp._assemble(row_vals.to(torch.bfloat16), row_cols,
                          [5] * n_big, shape=(n_big, n_big))
    check(big.indices.dtype == torch.int32 and big.data.dtype ==
          torch.bfloat16, "bf16 operator with n=40000 keeps int32 indices")
    xb = torch.randn((n_big, 4), generator=gen, device=dev)
    bb = torch.randn((n_big, 4), generator=gen, device=dev)
    pb = torch.randint(0, n_big, (512,), generator=gen, device=dev)
    vals, cols = big.padded_rows()
    e = rel(ops.sweep_rows_gs(vals, cols, bb, xb, pb, beta=0.9),
            ref.sweep_rows_gs_ref(vals, cols, bb, xb, pb, beta=0.9))
    check(e <= SWEEP_RTOL, f"sweep_rows_gs bf16/i32: rel err {e:.3e}")
    rnb = big.row_norms_sq()
    e = rel(ops.sweep_rows_rk(vals, cols, bb, rnb, xb, pb, beta=0.9),
            ref.sweep_rows_rk_ref(vals, cols, bb, rnb, xb, pb, beta=0.9))
    check(e <= SWEEP_RTOL, f"sweep_rows_rk bf16/i32: rel err {e:.3e}")
    db = torch.randn((n_big, 4), generator=gen, device=dev)
    got = ops.sweep_rows_rk_delta(vals, cols, bb, rnb, xb, db, pb, beta=0.9)
    want = ref.sweep_rows_rk_delta_ref(vals, cols, bb, rnb, xb, db, pb,
                                       beta=0.9)
    e = max(rel(got[0], want[0]), rel(got[1], want[1]))
    check(e <= SWEEP_RTOL, f"sweep_rows_rk_delta bf16/i32: rel err {e:.3e}")
    spmv_check("bf16/i32", big, xb, "sliced")
    spmv_check("bf16/i32", big, xb, "sliced_prefetch")
    spmv_check("bf16/i32", big, xb, "segsum")
    spmv_check("bf16/i32", big, xb, "segsum_prefetch")

    def ell_check(tag, vals, cols, x, counts):
        y = ops.spmv_ell(vals, cols, x, counts=counts)
        want = ref.spmv_ell_ref(vals, cols, x)
        torch.cuda.synchronize()
        scale = ref.spmv_ell_ref(vals.abs(), cols, x.abs())
        err = (y - want).abs()
        check(bool((err <= SPMV_RTOL * scale + SPMV_ATOL).all()),
              f"spmv_ell {tag}: max|kernel - plain| = {float(err.max()):.3e} "
              f"within {SPMV_RTOL:g}*(|A||x|) + {SPMV_ATOL:g}")
        return y, float(err.max())

    bv, bc = big.padded_rows()
    ell_check("bf16/i32 n=40000", bv, bc, xb, big.row_counts())
    row_window_beyond_main(torch, ops, ref, _spmv, ops_by[("spd", None)],
                           ops_by[("ell", None)], x_spd,
                           torch.Generator(dev).manual_seed(SEED + 19), dev)
    segsum_beyond_main(torch, ops, ref,
                       torch.Generator(dev).manual_seed(SEED + 23), dev)
    stops = {key: ops_by[key].stop_counts(K) is not None
             for key in (("spd", None), ("lsq", None), ("holes", None),
                         ("ell", None))}
    check(stops == {("spd", None): True, ("lsq", None): False,
                    ("holes", None): False, ("ell", None): True},
          "the main operators' matvecs stop each row where at least "
          f"{_spmv.STOP_PADDING_SHARE:g} of the slots are padding: SPD CSR "
          "and ELL do, the LSQ design and its empty-panel variant (no or "
          f"little padding) do not ({stops})")

    # The GS sweep's two paths.  At n = SPD_N the iterate fits shared
    # memory, so the checks above ran the shared-memory path; the global
    # path runs on synthetic windows over an iterate too tall for it, and
    # the two are held bitwise equal on a main-path chunk (the launcher
    # takes the global path when asked, at any n).  Draws from a generator
    # of their own leave the other checks' inputs as they were.
    gen_gs = torch.Generator(dev).manual_seed(SEED + 15)
    capacity = sweep_csr.shared_capacity(dev)
    check(sweep_csr.fits_shared(SPD_N, capacity),
          f"sweep_rows_gs n={SPD_N} takes the shared-memory path: one column "
          f"a CTA within the {capacity} bytes a CTA may opt into")
    check(not sweep_csr.fits_shared(GS_GLOBAL_N, capacity),
          f"sweep_rows_gs n={GS_GLOBAL_N} takes the global path")
    rows_g = torch.arange(GS_GLOBAL_N, device=dev)
    cols_g = torch.randint(0, GS_GLOBAL_N, (GS_GLOBAL_N, GS_GLOBAL_WIDTH),
                           generator=gen_gs, device=dev, dtype=torch.int32)
    cols_g[:, 0] = rows_g.to(torch.int32)          # the diagonal first
    vals_g = torch.randn((GS_GLOBAL_N, GS_GLOBAL_WIDTH), generator=gen_gs,
                         device=dev) * 0.05
    vals_g[:, 0] = 1.0
    b_g = torch.randn((GS_GLOBAL_N, GS_GLOBAL_K), generator=gen_gs, device=dev)
    x_g = torch.randn((GS_GLOBAL_N, GS_GLOBAL_K), generator=gen_gs, device=dev)
    picks_g = torch.randint(0, GS_GLOBAL_N, (PREFIX,), generator=gen_gs,
                            device=dev)
    for vdt in (torch.float32, torch.bfloat16):
        tag = "f32/i32" if vdt == torch.float32 else "bf16/i32"
        v = vals_g.to(vdt)
        got = ops.sweep_rows_gs(v, cols_g, b_g, x_g, picks_g, beta=0.9)
        want = ref.sweep_rows_gs_ref(v, cols_g, b_g, x_g, picks_g, beta=0.9)
        torch.cuda.synchronize()
        e = rel(got, want)
        check(e <= SWEEP_RTOL, f"sweep_rows_gs global path {tag} n="
              f"{GS_GLOBAL_N} width={GS_GLOBAL_WIDTH} k={GS_GLOBAL_K} {PREFIX} "
              f"picks: rel err {e:.3e} <= {SWEEP_RTOL:g}")
        if vdt == torch.float32:
            errs["sweep_rows_gs_global"] = float((got - want).abs().max())
    op = ops_by[("spd", None)]
    vals, cols = op.padded_rows()
    chunk_gs = draw_picks(op, "gs", SPD_N, generator=gen_gs).to(torch.int32)
    runs = [sweep_csr.sweep_rows_gs(vals, cols, spd.b, x_spd, chunk_gs,
                                    beta=1.0, write_base=0, limit=SPD_N,
                                    _shared=shared)
            for shared in (False, True)]
    torch.cuda.synchronize()
    check(torch.equal(*runs),
          f"sweep_rows_gs main-path chunk ({SPD_N} picks, k={K}): the global "
          "path and the shared-memory path agree bitwise")
    del runs
    # A distributed rank's local phase: the sweep over rank 2's slab of
    # the P = 4 partition (its rows of the windows and of b), writing at
    # write_base = 2 * slab of the full-length x: on both paths bitwise on
    # a whole slab of picks, against the plain version on a prefix, every
    # row outside the slab untouched.
    slab4 = SPD_N // P4
    w0 = 2 * slab4
    rank_rows = slice(w0, w0 + slab4)
    args = (vals[rank_rows], cols[rank_rows], spd.b[rank_rows], x_spd)
    picks_s = torch.randint(0, slab4, (slab4,), generator=gen_gs,
                            device=dev, dtype=torch.int32)
    runs = [sweep_csr.sweep_rows_gs(*args, picks_s, beta=0.9, write_base=w0,
                                    limit=slab4, _shared=shared)
            for shared in (False, True)]
    got = ops.sweep_rows_gs(*args, picks_s[:PREFIX], beta=0.9,
                            write_base=w0)
    want = ref.sweep_rows_gs_ref(*args, picks_s[:PREFIX], beta=0.9,
                                 write_base=w0)
    torch.cuda.synchronize()
    e = rel(got, want)
    check(torch.equal(*runs) and e <= SWEEP_RTOL
          and all(torch.equal(r[:w0], x_spd[:w0])
                  and torch.equal(r[w0 + slab4:], x_spd[w0 + slab4:])
                  for r in (*runs, got)),
          f"sweep_rows_gs at write_base={w0} (rank 2 of {P4}'s slab, "
          f"{slab4} picks, k={K}): the two paths bitwise, rel err {e:.3e} <= "
          f"{SWEEP_RTOL:g} against the plain version on {PREFIX} picks, the "
          "rows outside the slab untouched")
    del runs, got, want

    # The two RK sweeps' paths, as the GS sweep's: the main path's n =
    # LSQ_N takes the shared-memory path at one carry and at two (so the
    # checks above ran it); the global path runs on synthetic windows over
    # an iterate too tall for it (distinct columns per row, the first of
    # weight 1), and the two are held bitwise equal on a main-path chunk of
    # each kernel.
    for carries in (1, 2):
        check(sweep_csr.fits_shared(LSQ_N, capacity, carries),
              f"RK sweeps with {carries} carr{'y' if carries == 1 else 'ies'}"
              f" at n={LSQ_N} take the shared-memory path")
        check(not sweep_csr.fits_shared(RK_GLOBAL_N, capacity, carries),
              f"RK sweeps with {carries} carr{'y' if carries == 1 else 'ies'}"
              f" at n={RK_GLOBAL_N} take the global path")
    gen_rk = torch.Generator(dev).manual_seed(SEED + 17)
    offs = torch.randperm(RK_GLOBAL_N - 1, generator=gen_rk,
                          device=dev)[:RK_GLOBAL_WIDTH - 1] + 1
    base = torch.randint(0, RK_GLOBAL_N, (RK_GLOBAL_M, 1), generator=gen_rk,
                         device=dev)
    cols_r = torch.cat([base, (base + offs[None, :]) % RK_GLOBAL_N],
                       1).to(torch.int32)
    vals_r = torch.randn((RK_GLOBAL_M, RK_GLOBAL_WIDTH), generator=gen_rk,
                         device=dev) * 0.3
    vals_r[:, 0] = 1.0
    b_r = torch.randn((RK_GLOBAL_M, RK_GLOBAL_K), generator=gen_rk,
                      device=dev)
    x_r = torch.randn((RK_GLOBAL_N, RK_GLOBAL_K), generator=gen_rk,
                      device=dev)
    d_r = torch.randn((RK_GLOBAL_N, RK_GLOBAL_K), generator=gen_rk,
                      device=dev)
    picks_r = torch.randint(0, RK_GLOBAL_M, (PREFIX,), generator=gen_rk,
                            device=dev)
    for vdt in (torch.float32, torch.bfloat16):
        tag = "f32/i32" if vdt == torch.float32 else "bf16/i32"
        v = vals_r.to(vdt)
        rn_r = (v.float() ** 2).sum(1)
        shape = (f"{RK_GLOBAL_M}x{RK_GLOBAL_N} width={RK_GLOBAL_WIDTH} "
                 f"k={RK_GLOBAL_K} {PREFIX} picks")
        got = ops.sweep_rows_rk(v, cols_r, b_r, rn_r, x_r, picks_r, beta=0.9)
        want = ref.sweep_rows_rk_ref(v, cols_r, b_r, rn_r, x_r, picks_r,
                                     beta=0.9)
        torch.cuda.synchronize()
        e = rel(got, want)
        check(e <= SWEEP_RTOL, f"sweep_rows_rk global path {tag} {shape}: "
              f"rel err {e:.3e} <= {SWEEP_RTOL:g}")
        if vdt == torch.float32:
            errs["sweep_rows_rk_global"] = float((got - want).abs().max())
        got = ops.sweep_rows_rk_delta(v, cols_r, b_r, rn_r, x_r, d_r, picks_r,
                                      beta=0.9)
        want = ref.sweep_rows_rk_delta_ref(v, cols_r, b_r, rn_r, x_r, d_r,
                                           picks_r, beta=0.9)
        torch.cuda.synchronize()
        e = max(rel(got[0], want[0]), rel(got[1], want[1]))
        check(e <= SWEEP_RTOL, f"sweep_rows_rk_delta global path {tag} "
              f"{shape}: rel err of x and d {e:.3e} <= {SWEEP_RTOL:g}")
        if vdt == torch.float32:
            errs["sweep_rows_rk_delta_global"] = max(
                float((g - w).abs().max()) for g, w in zip(got, want))
        zero = torch.zeros_like(x_r)
        zx, zd = ops.sweep_rows_rk_delta(v, cols_r, b_r, rn_r, zero, zero,
                                         picks_r, beta=0.9)
        check(torch.equal(zx, zd) and bool(zx.any()),
              f"sweep_rows_rk_delta global path {tag}: from x = d = 0 the "
              "two carries end bitwise equal")
    op = ops_by[("lsq", None)]
    vals, cols = op.padded_rows()
    rn = op.row_norms_sq()
    chunk_rk = draw_picks(op, "rk", LSQ_M, generator=gen_rk).to(torch.int32)
    runs = [sweep_csr.sweep_rows_rk(vals, cols, lsq.b, rn, x_lsq, chunk_rk,
                                    beta=1.0, limit=LSQ_M, _shared=shared)
            for shared in (False, True)]
    torch.cuda.synchronize()
    check(torch.equal(*runs),
          f"sweep_rows_rk main-path chunk ({LSQ_M} picks, k={K}): the global "
          "path and the shared-memory path agree bitwise")
    runs = [sweep_csr.sweep_rows_rk_delta(
        vals, cols, lsq.b, rn, x_lsq, torch.zeros_like(x_lsq), chunk_rk,
        beta=1.0, limit=LSQ_M, _shared=shared) for shared in (False, True)]
    torch.cuda.synchronize()
    check(torch.equal(runs[0][0], runs[1][0])
          and torch.equal(runs[0][1], runs[1][1]),
          f"sweep_rows_rk_delta P = 1 round ({LSQ_M} picks, k={K}): the "
          "global path and the shared-memory path agree bitwise on x and d")
    del runs

    # Both RK sweeps on rows wider than the main path's 16 slots: ragged
    # windows (1 to `width` real slots, distinct columns, the rest padding:
    # value 0, column 0) over n = LSQ_N, which fits shared memory at both
    # carries, so each kernel runs on both paths, each held against the
    # plain version and the two held bitwise equal; from x = d = 0 the two
    # carries end bitwise equal on each path.
    gen_w = torch.Generator(dev).manual_seed(SEED + 19)
    for width in RK_WIDE_WIDTHS:
        offs = torch.randperm(LSQ_N - 1, generator=gen_w,
                              device=dev)[:width - 1] + 1
        base = torch.randint(0, LSQ_N, (RK_WIDE_M, 1), generator=gen_w,
                             device=dev)
        cols_w = torch.cat([base, (base + offs[None, :]) % LSQ_N], 1)
        vals_w = torch.randn((RK_WIDE_M, width), generator=gen_w,
                             device=dev) * 0.3
        vals_w[:, 0] = 1.0
        real = torch.randint(1, width + 1, (RK_WIDE_M, 1), generator=gen_w,
                             device=dev)
        pad = torch.arange(width, device=dev)[None, :] >= real
        vals_w[pad] = 0.0
        cols_w[pad] = 0
        b_w = torch.randn((RK_WIDE_M, RK_WIDE_K), generator=gen_w,
                          device=dev)
        x_w = torch.randn((LSQ_N, RK_WIDE_K), generator=gen_w, device=dev)
        d_w = torch.randn((LSQ_N, RK_WIDE_K), generator=gen_w, device=dev)
        picks_w = torch.randint(0, RK_WIDE_M, (PREFIX,), generator=gen_w,
                                device=dev).to(torch.int32)
        for vdt, idt, tag in ((torch.float32, torch.int32, "f32/i32"),
                              (torch.bfloat16, torch.int16, "bf16/i16")):
            v, c = vals_w.to(vdt), cols_w.to(idt)
            rn_w = (v.float() ** 2).sum(1)
            shape = (f"width={width} {RK_WIDE_M}x{LSQ_N} k={RK_WIDE_K} "
                     f"{PREFIX} picks")
            want = ref.sweep_rows_rk_ref(v, c, b_w, rn_w, x_w, picks_w,
                                         beta=0.9)
            runs = {}
            for shared, path in ((True, "shared-memory"), (False, "global")):
                got = sweep_csr.sweep_rows_rk(v, c, b_w, rn_w, x_w, picks_w,
                                              beta=0.9, limit=RK_WIDE_M,
                                              _shared=shared)
                torch.cuda.synchronize()
                runs[shared] = got
                e = rel(got, want)
                check(e <= SWEEP_RTOL, f"sweep_rows_rk {path} path {tag} "
                      f"{shape}: rel err {e:.3e} <= {SWEEP_RTOL:g}")
            check(torch.equal(runs[True], runs[False]),
                  f"sweep_rows_rk {tag} {shape}: the two paths agree bitwise")
            want = ref.sweep_rows_rk_delta_ref(v, c, b_w, rn_w, x_w, d_w,
                                               picks_w, beta=0.9)
            zero = torch.zeros_like(x_w)
            runs = {}
            for shared, path in ((True, "shared-memory"), (False, "global")):
                got = sweep_csr.sweep_rows_rk_delta(
                    v, c, b_w, rn_w, x_w, d_w, picks_w, beta=0.9,
                    limit=RK_WIDE_M, _shared=shared)
                zx, zd = sweep_csr.sweep_rows_rk_delta(
                    v, c, b_w, rn_w, zero, zero, picks_w, beta=0.9,
                    limit=RK_WIDE_M, _shared=shared)
                torch.cuda.synchronize()
                runs[shared] = got
                e = max(rel(got[0], want[0]), rel(got[1], want[1]))
                check(e <= SWEEP_RTOL, f"sweep_rows_rk_delta {path} path "
                      f"{tag} {shape}: rel err of x and d {e:.3e} <= "
                      f"{SWEEP_RTOL:g}")
                check(torch.equal(zx, zd) and bool(zx.any()),
                      f"sweep_rows_rk_delta {path} path {tag} width={width}:"
                      " from x = d = 0 the two carries end bitwise equal")
            check(torch.equal(runs[True][0], runs[False][0])
                  and torch.equal(runs[True][1], runs[False][1]),
                  f"sweep_rows_rk_delta {tag} {shape}: the two paths agree "
                  "bitwise on x and d")
        del runs

    # The column sums of the records: the kernel against its plain version
    # (each column reduced on its own contiguous copy) at the records'
    # shapes and at ragged ones, and column 0 at k = K bitwise equal to
    # k = 1.  The plain version on the card is torch.sum, the record sum
    # before this kernel: whether its column 0 depends on k is printed.
    for rows, kk in COLSUM_SHAPES:
        t = torch.randn((rows, kk), generator=gen_rk, device=dev) ** 2
        got, want = ops.colsum(t), ref.colsum_ref(t)
        one = ops.colsum(t[:, :1].contiguous())
        torch.cuda.synchronize()
        err = (got - want).abs()
        check(bool((err <= COLSUM_RTOL * t.abs().sum(0)).all()),
              f"colsum n={rows} k={kk}: max|kernel - plain| = "
              f"{float(err.max()):.3e} within {COLSUM_RTOL:g}*sum|t|")
        check(torch.equal(one[0], got[0]),
              f"colsum n={rows}: column 0 at k={kk} bitwise equals k=1")
        if (rows, kk) == (SPD_N, K):
            errs["colsum"] = float(err.max())
            plain_one = ref.colsum_ref(t[:, :1].contiguous())
            print(f"  torch.sum on the card (the plain version; the record "
                  f"sums before the colsum kernel), n={rows}: column 0 at "
                  f"k={kk} and at k=1 "
                  + ("bitwise equal" if torch.equal(plain_one[0], want[0])
                     else f"differ by {float((plain_one[0] - want[0]).abs()):.3e}"),
                  flush=True)

    # The ELL and block-banded kernels at the main paths' shapes.  The
    # banded sweep runs the first chunk (one sweep, nb picks) of a
    # main-path pick stream.
    nb = SPD_N // BLOCK
    halo = BANDS * BLOCK
    x_band = torch.randn((SPD_N, K), generator=gen, device=dev)
    xw_band = torch.nn.functional.pad(x_band, (0, 0, halo, halo))
    band_picks = draw_picks(ops_by[("banded", None)], "gs",
                            BANDED_SWEEPS * nb, generator=gen)[:nb]
    for sd in (None, "bfloat16"):
        tag = "f32/i32" if sd is None else "bf16/i16"
        op = ops_by[("ell", sd)]
        _, errs[("spmv_ell", sd)] = ell_check(
            f"{tag} n={SPD_N} width={ell_width} k={K}", op.vals, op.cols,
            x_spd, op.row_counts())

        tag = "f32" if sd is None else "bf16"
        op = ops_by[("banded", sd)]
        y = ops.bbmv(op.A_bands, x_band, bands=BANDS, block=BLOCK)
        want = ref.bbmv_ref(op.A_bands, x_band, bands=BANDS, block=BLOCK)
        torch.cuda.synchronize()
        scale = ref.bbmv_ref(op.A_bands.abs(), x_band.abs(), bands=BANDS,
                             block=BLOCK)
        err = (y - want).abs()
        check(bool((err <= BBMV_RTOL * scale + BBMV_ATOL).all()),
              f"bbmv {tag} nb={nb} block={BLOCK} bands={BANDS} k={K}: "
              f"max|kernel - plain| = {float(err.max()):.3e} within "
              f"{BBMV_RTOL:g}*(|A||x|) + {BBMV_ATOL:g} (largest ratio to "
              f"|A||x| {float((err / scale.clamp(min=1e-30)).max()):.3e})")
        errs[("bbmv", sd)] = float(err.max())
        one = ops.bbmv(op.A_bands, x_band[:, :1].contiguous(), bands=BANDS,
                       block=BLOCK)
        check(torch.equal(one[:, 0], y[:, 0]),
              f"bbmv {tag}: column 0 at k={K} bitwise equals k=1")

        packed = op.packed_band_tiles()
        got = ops.banded_gs_sweep(packed, banded.b, xw_band, band_picks,
                                  block=BLOCK, bands=BANDS, beta=0.9)
        want = ref_banded.banded_gs_sweep_ref(packed, banded.b, xw_band,
                                              band_picks, block=BLOCK,
                                              bands=BANDS, beta=0.9)
        torch.cuda.synchronize()
        e = rel(got, want)
        check(e <= SWEEP_RTOL, f"banded_gs_sweep {tag} nb={nb} k={K} "
              f"{nb} picks: rel err {e:.3e} <= {SWEEP_RTOL:g}")
        errs[("banded_gs_sweep", sd)] = float((got - want).abs().max())
        one = ops.banded_gs_sweep(packed, banded.b[:, :1].contiguous(),
                                  xw_band[:, :1].contiguous(), band_picks,
                                  block=BLOCK, bands=BANDS, beta=0.9)
        check(torch.equal(one[:, 0], got[:, 0]),
              f"banded_gs_sweep {tag}: column 0 at k={K} bitwise equals k=1")

    # bbmv at ragged shapes, in f32 and bf16, and at the main shape with two
    # column tiles (the kernel's column-tile width, x staged element by
    # element) bitwise equal to one (x staged as contiguous runs).
    for blk in RAGGED_BLOCKS:
        for vdt in (torch.float32, torch.bfloat16):
            tiles = torch.randn((RAGGED_NB, 2 * BANDS + 1, blk, blk),
                                generator=gen_gs, device=dev).to(vdt)
            for kk in RAGGED_KS if vdt == torch.float32 else (K,):
                xr = torch.randn((RAGGED_NB * blk, kk), generator=gen_gs,
                                 device=dev)
                y = ops.bbmv(tiles, xr, bands=BANDS, block=blk)
                want = ref.bbmv_ref(tiles, xr, bands=BANDS, block=blk)
                torch.cuda.synchronize()
                scale = ref.bbmv_ref(tiles.abs(), xr.abs(), bands=BANDS,
                                     block=blk)
                err = (y - want).abs()
                check(bool((err <= BBMV_RTOL * scale + BBMV_ATOL).all()),
                      f"bbmv {str(vdt)[6:]} nb={RAGGED_NB} block={blk} "
                      f"bands={BANDS} k={kk}: max|kernel - plain| = "
                      f"{float(err.max()):.3e} within {BBMV_RTOL:g}*(|A||x|)"
                      f" + {BBMV_ATOL:g}")
    op = ops_by[("banded", None)]
    one_tile = ops.bbmv(op.A_bands, x_band, bands=BANDS, block=BLOCK)
    two_tiles = _bbmv.bbmv(op.A_bands, x_band, bands=BANDS, block=BLOCK,
                           _col_warps=1)
    check(torch.equal(one_tile, two_tiles), f"bbmv nb={nb} block={BLOCK} "
          f"k={K}: two column tiles of 32 bitwise equal one of 64")

    # The distributed engine's local-phase kernels at the main paths'
    # shapes: sweep_rows_rk_delta on a PREFIX-pick prefix of rank 0's slab
    # of the LSQ problem at P = 4; banded_rk_sweep on one P = 4 round
    # (P4_BANDED_STEPS picks of the global panel stream) on rank 1's
    # window, an interior one with halos on both sides, whose gates are
    # mixed (at P = 1 every gate is 1).
    slab = LSQ_M // P4
    nb_local = nb // P4
    row0 = nb_local * BLOCK
    d_lsq = torch.randn((LSQ_N, K), generator=gen, device=dev)
    panel_w = ops_by[("banded", None)].row_norms_sq().sum(1)
    round_picks = sample_rows(panel_w, P4_BANDED_STEPS, generator=gen)
    li = round_picks - nb_local
    gates = ((li >= 0) & (li < nb_local)).to(torch.int32)
    lic = li.clamp(0, nb_local - 1)
    check(0 < int(gates.sum()) < P4_BANDED_STEPS,
          f"banded_rk_sweep check round: {int(gates.sum())} of "
          f"{P4_BANDED_STEPS} picks owned by rank 1 (mixed gates)")
    dw_band = torch.randn((row0 + 2 * halo, K), generator=gen, device=dev)
    rk_args = {}
    for sd in (None, "bfloat16"):
        tag = "f32/i32" if sd is None else "bf16/i16"
        op = ops_by[("lsq", sd)]
        vals, cols = (a[:slab] for a in op.padded_rows())
        rn = op.row_norms_sq()[:slab]
        picks = sample_rows(rn, PREFIX, generator=gen)
        args = (vals, cols, lsq.b[:slab], rn)
        got = ops.sweep_rows_rk_delta(*args, x_lsq, d_lsq, picks, beta=0.9)
        want = ref.sweep_rows_rk_delta_ref(*args, x_lsq, d_lsq, picks,
                                           beta=0.9)
        torch.cuda.synchronize()
        e = max(rel(got[0], want[0]), rel(got[1], want[1]))
        check(e <= SWEEP_RTOL, f"sweep_rows_rk_delta {tag} slab {slab}x"
              f"{LSQ_N} k={K} {PREFIX} picks: rel err of x and d {e:.3e} <= "
              f"{SWEEP_RTOL:g}")
        errs[("sweep_rows_rk_delta", sd)] = max(
            float((g - w).abs().max()) for g, w in zip(got, want))
        zero = torch.zeros_like(x_lsq)
        zx, zd = ops.sweep_rows_rk_delta(*args, zero, zero, picks, beta=0.9)
        check(torch.equal(zx, zd) and bool(zx.any()),
              f"sweep_rows_rk_delta {tag}: from x = d = 0 the two carries "
              "end bitwise equal")
        one = ops.sweep_rows_rk_delta(
            vals, cols, lsq.b[:slab, :1].contiguous(), rn,
            x_lsq[:, :1].contiguous(), d_lsq[:, :1].contiguous(), picks,
            beta=0.9)
        check(torch.equal(one[0][:, 0], got[0][:, 0])
              and torch.equal(one[1][:, 0], got[1][:, 0]),
              f"sweep_rows_rk_delta {tag}: column 0 at k={K} bitwise equals "
              "k=1")
        if sd is None:
            rk_args["sweep_rows_rk_delta"] = (args, picks)

        tag = "f32" if sd is None else "bf16"
        op = ops_by[("banded", sd)]
        rnb = op.row_norms_sq()
        rnb = torch.where(rnb > 0, rnb, 1.0)[nb_local:2 * nb_local]
        args = (op.packed_band_tiles()[nb_local:2 * nb_local],
                banded.b[row0:2 * row0], rnb)
        xw = xw_band[row0:2 * row0 + 2 * halo]
        kw = dict(block=BLOCK, bands=BANDS, beta=0.9)
        got = ops.banded_rk_sweep(*args, xw, dw_band, lic, gates, **kw)
        want = ref_banded.banded_rk_sweep_ref(*args, xw, dw_band, lic, gates,
                                              **kw)
        torch.cuda.synchronize()
        e = max(rel(got[0], want[0]), rel(got[1], want[1]))
        check(e <= SWEEP_RTOL, f"banded_rk_sweep {tag} nb_local={nb_local} "
              f"k={K} {P4_BANDED_STEPS} picks, mixed gates: rel err of xw and "
              f"dw {e:.3e} <= {SWEEP_RTOL:g}")
        errs[("banded_rk_sweep", sd)] = max(
            float((g - w).abs().max()) for g, w in zip(got, want))
        same = ops.banded_rk_sweep(*args, xw, dw_band, lic,
                                   torch.zeros_like(gates), **kw)
        check(torch.equal(same[0], xw) and torch.equal(same[1], dw_band),
              f"banded_rk_sweep {tag}: all gates 0 leave xw and dw bitwise "
              "unchanged")
        zero = torch.zeros_like(xw)
        zx, zd = ops.banded_rk_sweep(*args, zero, zero, lic,
                                     torch.ones_like(gates), **kw)
        check(torch.equal(zx, zd) and bool(zx.any()),
              f"banded_rk_sweep {tag}: from xw = dw = 0 with all gates 1 the "
              "two windows end bitwise equal")
        one = ops.banded_rk_sweep(args[0], args[1][:, :1].contiguous(),
                                  args[2], xw[:, :1].contiguous(),
                                  dw_band[:, :1].contiguous(), lic, gates,
                                  **kw)
        check(torch.equal(one[0][:, 0], got[0][:, 0])
              and torch.equal(one[1][:, 0], got[1][:, 0]),
              f"banded_rk_sweep {tag}: column 0 at k={K} bitwise equals k=1")
        if sd is None:
            rk_args["banded_rk_sweep"] = (args, xw)

    # The banded sweeps' global path (the window in global memory) at the
    # main shapes, bitwise equal to what the wrappers launch there (the
    # shared-memory path), on the GS chunk and on the P = 4 check round,
    # f32 and bf16 tiles.  The bare launchers take int32 picks.
    band_picks32, lic32 = band_picks.to(torch.int32), lic.to(torch.int32)
    for sd in (None, "bfloat16"):
        tag = "f32" if sd is None else "bf16"
        op = ops_by[("banded", sd)]
        packed = op.packed_band_tiles()
        gs_kw = dict(block=BLOCK, bands=BANDS, beta=0.9, limit=nb)
        want = ops.banded_gs_sweep(packed, banded.b, xw_band, band_picks,
                                   block=BLOCK, bands=BANDS, beta=0.9)
        rnb = op.row_norms_sq()
        rnb = torch.where(rnb > 0, rnb, 1.0)[nb_local:2 * nb_local]
        args = (packed[nb_local:2 * nb_local], banded.b[row0:2 * row0], rnb)
        xw = xw_band[row0:2 * row0 + 2 * halo]
        rk_kw = dict(block=BLOCK, bands=BANDS, beta=0.9, limit=nb_local)
        rwant = ops.banded_rk_sweep(*args, xw, dw_band, lic, gates,
                                    block=BLOCK, bands=BANDS, beta=0.9)
        got = _banded.banded_gs_sweep(packed, banded.b, xw_band, band_picks32,
                                      _shared=False, **gs_kw)
        rgot = _banded.banded_rk_sweep(*args, xw, dw_band, lic32, gates,
                                       _shared=False, **rk_kw)
        check(torch.equal(got, want)
              and all(torch.equal(g, w) for g, w in zip(rgot, rwant)),
              f"banded sweeps {tag}, global path: the GS chunk and the P = 4 "
              "round bitwise equal the wrappers' launch")
    banded_beyond_main(torch, ops, _banded, ref_banded,
                       RAGGED_BLOCKS + (ops.MAX_BLOCK,), BANDED_WIDE_BANDS,
                       RAGGED_KS, gen_gs, dev)
    for blk, bands_list in BANDED_MANY_BANDS:
        banded_beyond_main(torch, ops, _banded, ref_banded, (blk,),
                           bands_list, BANDED_MANY_BANDS_KS, gen_gs, dev)

    # The dense block-GS kernel on the banded problem's dense matrix (1 GiB
    # of f32, and a bf16 copy), over the first chunk of a main-path pick
    # stream: nb picks of BLOCK-row panels.
    dense_ops = {sd: as_operator(banded.A, "dense", storage_dtype=sd)
                 for sd in (None, "bfloat16")}
    dense_picks = draw_picks(dense_ops[None], "gs", DENSE_SWEEPS * nb,
                             generator=gen, block=BLOCK)[:nb]
    for sd, op in dense_ops.items():
        tag = "f32" if sd is None else "bf16"
        kw = dict(block=BLOCK, beta=0.9)
        got = ops.block_gs_sweep(op.A, banded.b, x_band, dense_picks, **kw)
        want = ref.block_gs_sweep_ref(op.A, banded.b, x_band, dense_picks,
                                      **kw)
        torch.cuda.synchronize()
        e = rel(got, want)
        check(e <= SWEEP_RTOL, f"block_gs_sweep {tag} n={SPD_N} block={BLOCK} "
              f"k={K} {nb} picks: rel err {e:.3e} <= {SWEEP_RTOL:g}")
        errs[("block_gs_sweep", sd)] = float((got - want).abs().max())
        again = ops.block_gs_sweep(op.A, banded.b, x_band, dense_picks, **kw)
        check(torch.equal(again, got),
              f"block_gs_sweep {tag}: two runs agree bitwise")
        one = ops.block_gs_sweep(op.A, banded.b[:, :1].contiguous(),
                                 x_band[:, :1].contiguous(), dense_picks, **kw)
        check(torch.equal(one[:, 0], got[:, 0]),
              f"block_gs_sweep {tag}: column 0 at k={K} bitwise equals k=1")
    block_gs_beyond_main(torch, ops, _block_gs, ref,
                         torch.Generator(dev).manual_seed(SEED + 18), dev)
    # The dense record matvec: torch.matmul picks its kernel by shape (at
    # one column a matrix-vector product), so DenseOp.matvec multiplies in
    # column groups of one width.  Whether one plain product's column 0
    # depends on k is printed; the grouped one's must not.
    dense = dense_ops[None]
    x1 = x_band[:, :1].contiguous()
    y_full, y_one = dense.A @ x_band, dense.A @ x1
    print(f"  torch.matmul with the dense A, one product: column 0 at k={K} "
          "and at k=1 " + ("bitwise equal" if torch.equal(y_one[:, 0], y_full[:, 0])
                           else "differ by up to "
                           f"{float((y_one[:, 0] - y_full[:, 0]).abs().max()):.3e}"),
          flush=True)
    check(torch.equal(dense.matvec(x1)[:, 0], dense.matvec(x_band)[:, 0]),
          f"DenseOp.matvec (column groups of {DENSE_MATVEC_COLUMNS}): column 0 "
          f"at k={K} bitwise equals k=1")
    del dense_ops, dense, y_full, y_one

    # ELL windows of a matrix full of magnitude ties: the card's stable
    # sort orders them as the CPU's (which the tests hold against JAX)
    lap = laplacian_spd(24, device=dev)
    gv, gc = ell_from_dense(lap.A, 5)
    cv, cc = ell_from_dense(lap.A.cpu(), 5)
    check(torch.equal(gv.cpu(), cv) and torch.equal(gc.cpu(), cc),
          "ELL windows of laplacian_spd(24) (ties) equal on the card and "
          "the CPU")

    # degenerate pick streams: empty (a no-op) and one row over and over
    op = ops_by[("spd", None)]
    vals, cols = op.padded_rows()
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    check(torch.equal(ops.sweep_rows_gs(vals, cols, spd.b, x_spd, empty),
                      x_spd), "sweep_rows_gs with no picks returns x")
    rep = torch.full((64,), 5, dtype=torch.int64, device=dev)
    e = rel(ops.sweep_rows_gs(vals, cols, spd.b, x_spd, rep, beta=0.7),
            ref.sweep_rows_gs_ref(vals, cols, spd.b, x_spd, rep, beta=0.7))
    check(e <= SWEEP_RTOL, f"sweep_rows_gs repeated row: rel err {e:.3e}")

    # the whole solve on a small input agrees with the CPU path (the plain
    # versions, which the tests hold against the JAX reference)
    small = random_sparse_spd(256, row_nnz=6, n_rhs=4, seed=3, device=dev)
    small_cpu = type(small)(*(t.cpu() for t in small))
    sched = Schedule(num_iters=1024, record_every=256)
    picks = torch.randint(0, 256, (1024,), generator=gen, device=dev)
    r_gpu = solve(small, format="csr", schedule=sched, picks=picks)
    r_cpu = solve(small_cpu, format="csr", schedule=sched, picks=picks.cpu())
    e = rel(r_gpu.x.cpu(), r_cpu.x)
    check(e <= SWEEP_RTOL, f"small GS solve, card vs CPU: rel err {e:.3e}")
    check(torch.allclose(r_gpu.resid.cpu(), r_cpu.resid, rtol=1e-4,
                         atol=1e-5), "small GS solve residuals, card vs CPU")
    small_b = block_banded_spd(256, block=32, bands=2, n_rhs=4, seed=3,
                               device=dev)
    for fmt, prob, kw, top in (
            ("ell", small, dict(width=12), 256),
            ("banded", small_b, dict(block=32, bands=2), 8)):
        prob_cpu = type(prob)(*(t.cpu() for t in prob))
        picks = torch.randint(0, top, (1024,), generator=gen, device=dev)
        r_gpu = solve(prob, format=fmt, schedule=sched, picks=picks, **kw)
        r_cpu = solve(prob_cpu, format=fmt, schedule=sched,
                      picks=picks.cpu(), **kw)
        e = rel(r_gpu.x.cpu(), r_cpu.x)
        check(e <= SWEEP_RTOL and torch.allclose(
            r_gpu.resid.cpu(), r_cpu.resid, rtol=1e-4, atol=1e-5),
            f"small {fmt} GS solve, card vs CPU: rel err {e:.3e}, "
            "residuals within rtol 1e-4")

    print("== main path", flush=True)
    # Each path runs with the launch counters set to 0 just before it and
    # read just after: it must have launched exactly its kernels, once per
    # record chunk (the sweep), once per matvec of record_metrics (two per
    # GS record: A e and A x; one per RK record: A x) and twice per record
    # for its column sums (err_sq and resid), and nothing else, so no
    # chunk or record fell back to a plain version.
    # The CSR solves run SOLVE_RUNS times (each with its counters checked)
    # and their wall times print as the median with the spread; the
    # launches of a path's first run go into the JSON line.
    launches = dict.fromkeys(ops.KERNELS, 0)

    def drive(tag, expect, run, runs=1):
        walls = []
        for i in range(runs):
            torch.cuda.synchronize()    # no earlier work in this path's time
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = ops.launch_counts()
            check(got == {name: expect.get(name, 0) for name in ops.KERNELS},
                  f"{tag} launched exactly {expect}")
            if i == 0:
                for name, n in got.items():
                    launches[name] += n
        w = sorted(walls)
        spread = (f" (median of {runs}; min {w[0]:.4f}, max {w[-1]:.4f})"
                  if runs > 1 else "")
        print(f"  {tag}: {w[len(w) // 2]:.4f} s wall{spread} (operator build "
              f"included), launches {({k: v for k, v in got.items() if v})}",
              flush=True)
        return res

    def gs_sched(sweeps, n):
        return Schedule(num_iters=sweeps * n, record_every=n)

    gs = drive(f"CSR GS, {GS_SWEEPS} sweeps",
               dict(sweep_rows_gs=GS_SWEEPS, spmv_csr_sliced=2 * GS_SWEEPS,
                    colsum=2 * GS_SWEEPS),
               lambda: solve(spd, format="csr",
                             generator=torch.Generator(dev).manual_seed(1),
                             schedule=gs_sched(GS_SWEEPS, SPD_N)),
               runs=SOLVE_RUNS)
    rk = drive(f"CSR RK, {RK_SWEEPS} sweeps",
               dict(sweep_rows_rk=RK_SWEEPS, spmv_csr_sliced=RK_SWEEPS,
                    colsum=2 * RK_SWEEPS),
               lambda: solve(lsq, format="csr",
                             generator=torch.Generator(dev).manual_seed(2),
                             schedule=gs_sched(RK_SWEEPS, LSQ_M)),
               runs=SOLVE_RUNS)
    rkh = drive("CSR RK on the empty-panel design, 1 sweep",
                dict(sweep_rows_rk=1, spmv_csr_sliced_prefetch=1, colsum=2),
                lambda: solve(lsq_holes, format="csr",
                              generator=torch.Generator(dev).manual_seed(3),
                              schedule=gs_sched(1, LSQ_M)),
                runs=SOLVE_RUNS)
    eg = drive(f"ELL GS (width {ell_width}), {ELL_SWEEPS} sweeps",
               dict(sweep_rows_gs=ELL_SWEEPS, spmv_ell=2 * ELL_SWEEPS,
                    colsum=2 * ELL_SWEEPS),
               lambda: solve(spd, format="ell",
                             generator=torch.Generator(dev).manual_seed(1),
                             schedule=gs_sched(ELL_SWEEPS, SPD_N)))
    bg = drive(f"banded GS (block {BLOCK}, bands {BANDS}), {BANDED_SWEEPS} "
               "sweeps", dict(banded_gs_sweep=BANDED_SWEEPS,
                              bbmv=2 * BANDED_SWEEPS,
                              colsum=2 * BANDED_SWEEPS),
               lambda: solve(banded, format="banded", block=BLOCK,
                             bands=BANDS,
                             generator=torch.Generator(dev).manual_seed(5),
                             schedule=gs_sched(BANDED_SWEEPS, nb)))
    # Dense block GS on the same problem and generator seed, so on the same
    # block-row picks: one block_gs_sweep launch per record chunk; its
    # record matvecs are torch.matmul (no kernel, as in the reference).
    dg = drive(f"dense block GS (gs_block {BLOCK}), {DENSE_SWEEPS} sweeps",
               dict(block_gs_sweep=DENSE_SWEEPS, colsum=2 * DENSE_SWEEPS),
               lambda: solve(banded, format="dense", gs_block=BLOCK,
                             generator=torch.Generator(dev).manual_seed(5),
                             schedule=gs_sched(DENSE_SWEEPS, nb)))

    # Block GS on CSR, at gs_block 8 and 128 (csr_block_gs_phase).
    csr_bgs, csr_bgs_out = csr_block_gs_phase(torch, ops, ref, sweep_csr, spd,
                                              drive, smi)

    # Column 0 of each path solved alone (k = 1) on the same picks: the
    # same generator seed, and no stream depends on k.  Its iterate, err_sq
    # and resid must be bitwise column 0 of the k = K solve (DESIGN.md §8).
    def alone(prob, **kw):
        return solve(prob._replace(b=prob.b[:, :1].contiguous(),
                                   x_star=prob.x_star[:, :1].contiguous()),
                     **kw)

    solos = {
        "CSR GS": (gs, alone(
            spd, format="csr", generator=torch.Generator(dev).manual_seed(1),
            schedule=gs_sched(GS_SWEEPS, SPD_N))),
        "CSR RK": (rk, alone(
            lsq, format="csr", generator=torch.Generator(dev).manual_seed(2),
            schedule=gs_sched(RK_SWEEPS, LSQ_M))),
        "ELL GS": (eg, alone(
            spd, format="ell", generator=torch.Generator(dev).manual_seed(1),
            schedule=gs_sched(ELL_SWEEPS, SPD_N))),
        "banded GS": (bg, alone(
            banded, format="banded", block=BLOCK, bands=BANDS,
            generator=torch.Generator(dev).manual_seed(5),
            schedule=gs_sched(BANDED_SWEEPS, nb))),
        "dense block GS": (dg, alone(
            banded, format="dense", gs_block=BLOCK,
            generator=torch.Generator(dev).manual_seed(5),
            schedule=gs_sched(DENSE_SWEEPS, nb)))}
    for tag, (res, kw) in csr_bgs.items():
        solos[tag] = (res, alone(spd, **dict(
            kw, generator=torch.Generator(dev).manual_seed(CSR_BGS_SEED))))

    # The CSR matvec seam: each variant launches exactly its kernel, on the
    # CSR GS operator and on the empty-panel design.
    variant_kernel = {"sliced": "spmv_csr_sliced",
                      "sliced_prefetch": "spmv_csr_sliced_prefetch",
                      "segsum": "spmv_csr", "segsum_prefetch": "spmv_csr_prefetch"}
    for tag, op, x in (("the SPD operator", ops_by[("spd", None)], x_spd),
                       ("the empty-panel design", holes, x_lsq)):
        ys = {v: drive(f"CsrOp.matvec(variant={v!r}) on {tag}",
                       {variant_kernel[v]: 1},
                       functools.partial(op.matvec, x, variant=v))
              for v in MATVEC_VARIANTS}
        seg = drive(f"CsrOp.matvec_segsum on {tag}", dict(spmv_csr=1),
                    functools.partial(op.matvec_segsum, x))
        segp = drive(f"CsrOp.matvec_segsum(skip_empty=True) on {tag}",
                     dict(spmv_csr_prefetch=1),
                     functools.partial(op.matvec_segsum, x, skip_empty=True))
        scale = matvec_scale(op, x)
        check(torch.equal(ys["sliced"], ys["sliced_prefetch"])
              and torch.equal(ys["segsum"], ys["segsum_prefetch"])
              and torch.equal(seg, ys["segsum"])
              and torch.equal(segp, ys["segsum"])
              and bool(((ys["segsum"] - ys["sliced"]).abs()
                        <= SPMV_RTOL * scale + SPMV_ATOL).all()),
              f"matvec variants on {tag}: each predicated twin bitwise its "
              "plain kernel, matvec_segsum bitwise variant 'segsum', segsum "
              f"within {SPMV_RTOL:g}*(|A||x|) + {SPMV_ATOL:g} of sliced")

    # The autotuner CLI in a child process (it times the four variants and
    # three panel layouts on the card), then show and diff of its table,
    # those two together.
    print("  autotuner child processes:", flush=True)

    def autotune(runs):
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        procs = {what: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.tune.autotune", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for what, argv in runs.items()}
        outs = {}
        try:
            for what, proc in procs.items():
                outs[what] = proc.communicate(timeout=400)[0]
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for what, proc in procs.items():
            for line in outs[what].splitlines():
                print(f"    [{what}] {line}", flush=True)
            check(proc.returncode == 0, f"autotune {what} exited 0 "
                  f"({time.perf_counter() - t0:.2f} s)")

    with tempfile.TemporaryDirectory() as tmp:
        tpath = str(Path(tmp) / "TUNE_torch_cuda.json")
        autotune({"sweep": ["sweep", "--n", str(SPD_N), "--k", str(K),
                            "--out", tpath]})
        autotune({"show": ["show", tpath], "diff": ["diff", tpath, tpath]})
        tuned = TuningTable.load(tpath)
    choice = tuned.lookup(runtime.matvec_key(ops_by[("spd", None)]))
    with use_table(tuned):
        rpp = runtime.tuned_rows_per_panel(SPD_N)
    check(choice in MATVEC_VARIANTS and rpp in (4, 8, 16)
          and tuned.device_kind == torch.cuda.get_device_name(0),
          f"the table names matvec variant {choice!r} and rows_per_panel "
          f"{rpp} for n={SPD_N}, measured on {tuned.device_kind}")

    def solve_under(table, prob, **kw):
        with use_table(table):
            return solve(prob, **kw)

    # One CSR GS sweep under that table: its two record matvecs launch the
    # variant it names (the first sweep of the CSR GS path's picks).
    tg = drive(f"CSR GS, 1 sweep, under the autotuner's table (matvec "
               f"{choice!r}, rows_per_panel {rpp})",
               {"sweep_rows_gs": 1, variant_kernel[choice]: 2, "colsum": 2},
               lambda: solve_under(
                   tuned, spd, format="csr",
                   generator=torch.Generator(dev).manual_seed(1),
                   schedule=gs_sched(1, SPD_N)))
    # A table naming the segment sum steers the engine's matvec to it.
    steer = TuningTable.fresh(dev)
    steer.record(runtime.matvec_key(holes), "segsum_prefetch",
                 {"segsum_prefetch": 0.0})
    rks = drive("CSR RK on the empty-panel design, 1 sweep, under a table "
                "naming 'segsum_prefetch'",
                dict(sweep_rows_rk=1, spmv_csr_prefetch=1, colsum=2),
                lambda: solve_under(
                    steer, lsq_holes, format="csr",
                    generator=torch.Generator(dev).manual_seed(3),
                    schedule=gs_sched(1, LSQ_M)))
    # The distributed engine at P = 1 on a world-size-1 gloo group: one
    # local-phase launch, one matvec (the residual of the rank's rows) and
    # two column sums (resid and err_sq) per round, and no collective.
    with tempfile.TemporaryDirectory() as store, \
            process_group("gloo", store) as pg:
        drk = drive(f"distributed RK on CSR, P = 1, {DIST_RK_ROUNDS} rounds "
                    f"of {LSQ_M} local steps",
                    dict(sweep_rows_rk_delta=DIST_RK_ROUNDS,
                         spmv_ell=DIST_RK_ROUNDS, colsum=2 * DIST_RK_ROUNDS),
                    lambda: solve(lsq, format="csr", group=pg, sync="psum",
                                  seed=SEED + 11,
                                  schedule=Schedule(rounds=DIST_RK_ROUNDS,
                                                    local_steps=LSQ_M)))
        solos["distributed RK on CSR, P = 1"] = (drk, alone(
            lsq, format="csr", group=pg, sync="psum", seed=SEED + 11,
            schedule=Schedule(rounds=DIST_RK_ROUNDS, local_steps=LSQ_M)))
        dbk = drive(f"distributed banded RK, P = 1, {BANDED_RK_ROUNDS} "
                    f"rounds of {nb} local steps",
                    dict(banded_rk_sweep=BANDED_RK_ROUNDS,
                         bbmv=BANDED_RK_ROUNDS, colsum=2 * BANDED_RK_ROUNDS),
                    lambda: solve(banded, format="banded", action="rk",
                                  block=BLOCK, bands=BANDS,
                                  beta=BANDED_RK_BETA, group=pg,
                                  seed=SEED + 12,
                                  schedule=Schedule(rounds=BANDED_RK_ROUNDS,
                                                    local_steps=nb)))
        # The distributed GS engine at P = 1: one local-phase launch a
        # round, then the records: sparse_gs two spmv_ell (A x and A e of
        # the rank's rows) and two colsum; banded_gs one bbmv a round and
        # one for b - A x* once; halo_gs two bbmv; dense_gs two matmuls
        # (no kernel); every one two colsum.  Each GS path alone at k = 1
        # too (the same seed, so the same picks).
        gs_paths = {
            "sparse_gs on CSR": (
                spd, "sparse_gs", SPD_N, DIST_GS_ROUNDS,
                dict(sweep_rows_gs=DIST_GS_ROUNDS,
                     spmv_ell=2 * DIST_GS_ROUNDS, colsum=2 * DIST_GS_ROUNDS),
                dict(format="csr")),
            "sparse_gs on ELL": (
                spd, "sparse_gs", SPD_N, DIST_GS_ROUNDS,
                dict(sweep_rows_gs=DIST_GS_ROUNDS,
                     spmv_ell=2 * DIST_GS_ROUNDS, colsum=2 * DIST_GS_ROUNDS),
                dict(format="ell")),
            "banded_gs": (
                banded, "banded_gs", nb, DIST_BANDED_GS_ROUNDS,
                dict(banded_gs_sweep=DIST_BANDED_GS_ROUNDS,
                     bbmv=DIST_BANDED_GS_ROUNDS + 1,
                     colsum=2 * DIST_BANDED_GS_ROUNDS),
                dict(format="banded", block=BLOCK, bands=BANDS,
                     sync="allgather")),
            "halo_gs": (
                banded, "halo_gs", nb, DIST_BANDED_GS_ROUNDS,
                dict(banded_gs_sweep=DIST_BANDED_GS_ROUNDS,
                     bbmv=2 * DIST_BANDED_GS_ROUNDS,
                     colsum=2 * DIST_BANDED_GS_ROUNDS),
                dict(format="banded", block=BLOCK, bands=BANDS)),
            f"dense_gs (gs_block {BLOCK})": (
                banded, "dense_gs", nb, DIST_BANDED_GS_ROUNDS,
                dict(block_gs_sweep=DIST_BANDED_GS_ROUNDS,
                     colsum=2 * DIST_BANDED_GS_ROUNDS),
                dict(format="dense", gs_block=BLOCK))}
        dgs = {}
        for name, (prob, kind, steps, rounds, expect, kw) in \
                gs_paths.items():
            kw = dict(kw, group=pg, seed=SEED + 13,
                      schedule=Schedule(rounds=rounds, local_steps=steps))
            tag = (f"distributed {name}, P = 1, {rounds} rounds of {steps} "
                   "local steps")
            dgs[name] = drive(tag, expect,
                              functools.partial(solve, prob, **kw))
            solos[f"distributed {name}, P = 1"] = (dgs[name],
                                                   alone(prob, **kw))
    print(f"  launches on the main paths, all together: {launches}",
          flush=True)
    fields = ("x", "err_sq", "resid")
    for tag, (full, one) in solos.items():
        print(f"  {tag}: column 0 at k={K} against the solo k=1 solve: "
              + ", ".join(f"{f} " + ("bitwise equal" if torch.equal(
                  getattr(full, f)[:, :1], getattr(one, f)) else "differs")
                  for f in fields), flush=True)
    for tag, (full, one) in solos.items():
        check(all(torch.equal(getattr(full, f)[:, :1], getattr(one, f))
                  for f in fields),
              f"{tag}: column 0 at k={K} bitwise equals the solo k=1 solve "
              "(x, err_sq and resid)")
    del solos
    for name in ops.KERNELS:
        check(launches[name] > 0, f"main paths launched {name} "
              f"({launches[name]} times)")

    def monotone(tag, err, err0):
        seq = torch.cat([err0[None, :], err], 0).double()
        worst = float((seq[1:] / seq[:-1]).max())
        check(bool(torch.isfinite(seq).all()) and worst <= 1 + MONO_RTOL,
              f"{tag}: err_sq non-increasing at every record point (largest "
              f"ratio of consecutive records {worst:.6f})")

    def dense_resid(tag, prob, res):
        want = torch.linalg.vector_norm(prob.b - prob.A @ res.x, dim=0)
        e = float(((res.resid[-1] - want).abs() / want).max())
        check(e <= RESID_RTOL, f"{tag}: final residual from the matvec kernel "
              f"vs dense torch.matmul, max rel diff {e:.3e} <= "
              f"{RESID_RTOL:g}")

    for tag, prob, res in (("GS", spd, gs), ("ELL GS", spd, eg),
                           ("banded GS", banded, bg),
                           ("dense block GS", banded, dg)):
        check(res.x.shape == (SPD_N, K) and bool(torch.isfinite(res.x).all()),
              f"{tag} iterate finite, shape {tuple(res.x.shape)}")
        monotone(f"{tag} (A-norm)", res.err_sq, a_norm_sq(prob.A, prob.x_star))
        dense_resid(tag, prob, res)
    # the ELL and CSR solves share the problem, the generator seed and so
    # the picks: they differ only in the order each row window is summed
    e = rel(eg.x, gs.x)
    check(e <= SWEEP_RTOL, f"ELL GS and CSR GS, same picks: rel err of x "
          f"{e:.3e} <= {SWEEP_RTOL:g}")
    # dense and banded block GS share the problem and the picks: the same
    # function, summed in different orders
    e = rel(dg.x, bg.x)
    check(e <= SWEEP_RTOL, f"dense block GS and banded GS, same picks: rel "
          f"err of x {e:.3e} <= {SWEEP_RTOL:g}")
    check(bool((dg.resid[-1] < dg.resid[0]).all()),
          "dense block GS: the residual falls (column 0: "
          + ", ".join(f"{v:.4g}" for v in dg.resid[:, 0].tolist()) + ")")
    # the tuned and steered solves repeat the first sweep of the CSR GS
    # path and the empty-panel RK path: the same picks, another matvec
    e = max(rel(tg.err_sq[0], gs.err_sq[0]), rel(tg.resid[0], gs.resid[0]))
    check(e <= SWEEP_RTOL, f"CSR GS under the tuned table: first record "
          f"within {e:.3e} <= {SWEEP_RTOL:g} of the CSR GS path's")
    check(torch.equal(rks.x, rkh.x) and rel(rks.resid, rkh.resid)
          <= SWEEP_RTOL, "CSR RK under the segsum_prefetch table: the "
          "iterate bitwise, the residual within "
          f"{rel(rks.resid, rkh.resid):.3e} of the sliced matvec's")
    check(rk.x.shape == (LSQ_N, K) and bool(torch.isfinite(rk.x).all()),
          f"RK iterate finite, shape {tuple(rk.x.shape)}")
    monotone("RK (Euclidean)", rk.err_sq, (lsq.x_star ** 2).sum(0))
    dense_resid("RK", lsq, rk)
    monotone("RK, empty-panel design", rkh.err_sq,
             (lsq_holes.x_star ** 2).sum(0))
    dense_resid("RK, empty-panel design", lsq_holes, rkh)

    def schedule_numbers(tag, res, kind, steps, workers, sync="psum",
                         a2a_schedule=()):
        """tau and bytes_per_round of a result (a dict) are those of its
        schedule."""
        if kind.endswith("_gs"):
            tau = scheduled_tau(workers, steps)
        else:
            tau = scheduled_tau(workers, steps, shared_stream=True,
                                local_sampling=kind == "sparse_rk")
        nbytes = _sync_bytes_per_round(kind, n=res["x"].shape[0], k=K,
                                       num_workers=workers, sync=sync,
                                       halo=BANDS * BLOCK,
                                       a2a_schedule=a2a_schedule)
        check(res["tau"] == tau and res["bytes_per_round"] == nbytes,
              f"{tag}: tau {res['tau']} and bytes per round "
              f"{res['bytes_per_round']:g} are scheduled_tau and "
              "_sync_bytes_per_round of its schedule")

    for tag, prob, res, kind, steps in (
            ("distributed RK on CSR, P = 1", lsq, drk, "sparse_rk", LSQ_M),
            ("distributed banded RK, P = 1", banded, dbk, "banded_rk", nb),
            *((f"distributed {name}, P = 1", prob, dgs[name], kind, steps)
              for name, (prob, kind, steps, *_) in gs_paths.items())):
        check(res.x.shape == prob.x_star.shape
              and bool(torch.isfinite(res.x).all()),
              f"{tag}: iterate finite, shape {tuple(res.x.shape)}")
        check(bool((res.resid[-1] < res.resid[0]).all()),
              f"{tag}: the residual falls (column 0: "
              + ", ".join(f"{v:.4g}" for v in res.resid[:, 0].tolist()) + ")")
        dense_resid(tag, prob, res)
        schedule_numbers(tag, res._asdict(), kind, steps, 1)
    # the same picks in pairs: CSR and ELL sum each row window in other
    # orders; halo_gs's window is banded_gs's replica's; dense_gs sums the
    # same block-row products in another order
    e = rel(dgs["sparse_gs on ELL"].x, dgs["sparse_gs on CSR"].x)
    check(e <= SWEEP_RTOL, f"distributed sparse_gs at P = 1, ELL and CSR, "
          f"same picks: rel err of x {e:.3e} <= {SWEEP_RTOL:g}")
    check(torch.equal(dgs["halo_gs"].x, dgs["banded_gs"].x),
          "distributed halo_gs at P = 1: x bitwise banded_gs's, same picks")
    e = rel(dgs[f"dense_gs (gs_block {BLOCK})"].x, dgs["banded_gs"].x)
    check(e <= SWEEP_RTOL, f"distributed dense_gs and banded_gs at P = 1, "
          f"same picks: rel err of x {e:.3e} <= {SWEEP_RTOL:g}")

    print("== the rest of the distributed engine at P = 1: dense_rk, "
          "compress, overlap, partition='balanced'", flush=True)
    rest = engine_rest_p1_phase(torch, ops, lsq, spd, banded, launches, smi)
    dense = rest["dense"]
    dense_beta = theory.beta_opt_rk(rest["rho"], P4_DENSE_RK_STEPS - 1)
    # the LSQ design with its first quarter of rows scaled P4_SKEW-fold:
    # contiguous slabs carry unequal norm mass, the balanced ones within
    # 2x of uniform
    A_skew = lsq.A.clone()
    A_skew[:LSQ_M // 4] *= P4_SKEW
    skew = lsq._replace(A=A_skew, b=A_skew @ lsq.x_star)
    skew_csr = as_operator(A_skew, "csr")
    rn_skew = skew_csr.row_norms_sq()
    uniform = float(rn_skew.double().sum()) / P4
    mass = partition.slab_norm_mass(
        rn_skew, partition.balanced_row_permutation(skew_csr, P4).perm, P4)
    contiguous = partition.slab_norm_mass(
        rn_skew, torch.arange(LSQ_M, device=dev), P4)
    check(mass.max() <= 2 * uniform < contiguous.max(),
          f"the norm-skewed LSQ design at P = {P4}: balanced slabs carry "
          f"{', '.join(f'{v / uniform:.3f}' for v in mass)} of the uniform "
          f"norm mass (within 2x), contiguous slabs "
          f"{', '.join(f'{v / uniform:.3f}' for v in contiguous)}")
    del A_skew

    print(f"== P = {P4}: {P4} processes sharing the card, gloo over CUDA "
          "tensors", flush=True)
    # The problems are built once, here; the ranks rebuild the operators
    # from their arrays (convert.csr_from_arrays / banded_from_arrays).
    t0 = time.perf_counter()
    lap = laplacian_spd(FCG_SIDE, n_rhs=K, seed=SEED)
    lap_csr = as_operator(lap.A, "csr")
    lap = lap._replace(A=None)
    print(f"  laplacian_spd({FCG_SIDE}) and its CSR: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def csr_arrays(name, op):
        return {f"{name}_{f}": getattr(op, f).cpu() for f in (
            "data", "indices", "row_id", "row_start", "row_nnz")} | {
            f"{name}_layout": dict(
                shape=op.shape, nnz=op.nnz, row_cap=op.row_cap,
                rows_per_panel=op.rows_per_panel,
                panel_width=op.panel_width)}

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "p4.pt")
        torch.save(dict(
            **csr_arrays("lsq", ops_by[("lsq", None)]),
            **csr_arrays("spd", ops_by[("spd", None)]),
            **csr_arrays("lap", lap_csr),
            **csr_arrays("skew", skew_csr),
            skew_b=skew.b.cpu(), skew_x_star=skew.x_star.cpu(),
            dense_A=dense.A.cpu(), dense_b=dense.b.cpu(),
            dense_x_star=dense.x_star.cpu(), dense_beta=dense_beta,
            tiles=ops_by[("banded", None)].A_bands.cpu(),
            lsq_b=lsq.b.cpu(), lsq_x_star=lsq.x_star.cpu(),
            spd_b=spd.b.cpu(), spd_x_star=spd.x_star.cpu(),
            lap_b=lap.b.cpu(), lap_x_star=lap.x_star.cpu(),
            band_b=banded.b.cpu(), band_x_star=banded.x_star.cpu()), path)
        t0 = time.perf_counter()
        p4 = run_workers(p4_rank, P4, path, backend="gloo", device="cuda",
                         timeout=900)
        p4_wall = time.perf_counter() - t0
    print(f"  {P4} ranks spawned, run and joined in {p4_wall:.2f} s wall",
          flush=True)
    slab4, nb4 = SPD_N // P4, nb // P4
    gs_counts = {
        "sparse": lambda r: dict(sweep_rows_gs=r, spmv_ell=2 * r,
                                 colsum=2 * r),
        "banded_gs": lambda r: dict(banded_gs_sweep=r, bbmv=r + 1,
                                    colsum=2 * r),
        "halo_gs": lambda r: dict(banded_gs_sweep=r, bbmv=2 * r,
                                  colsum=2 * r),
        "dense_gs": lambda r: dict(block_gs_sweep=r, colsum=2 * r)}
    lap_plan, _ = _a2a_plan(lap_csr.slab_neighbors(P4), P4)
    # (tag, strategy, sync as resolved, problem, rounds, steps, launches,
    # whether the residual must fall P4_FALL-fold to P4_REL)
    p4_runs = (
        ("sparse_rk", "sparse_rk", "psum", lsq, P4_SPARSE_ROUNDS,
         P4_SPARSE_STEPS,
         dict(sweep_rows_rk_delta=P4_SPARSE_ROUNDS,
              spmv_ell=P4_SPARSE_ROUNDS, colsum=2 * P4_SPARSE_ROUNDS), True),
        ("banded_rk", "banded_rk", "psum", banded, P4_BANDED_ROUNDS,
         P4_BANDED_STEPS,
         dict(banded_rk_sweep=P4_BANDED_ROUNDS, bbmv=P4_BANDED_ROUNDS,
              colsum=2 * P4_BANDED_ROUNDS), True),
        ("sparse_gs", "sparse_gs", "allgather", spd, P4_SPARSE_GS_ROUNDS,
         slab4, gs_counts["sparse"](P4_SPARSE_GS_ROUNDS), True),
        ("sparse_gs a2a", "sparse_gs", "a2a", lap, P4_LAP_ROUNDS, slab4,
         gs_counts["sparse"](P4_LAP_ROUNDS), False),
        ("sparse_gs allgather", "sparse_gs", "allgather", lap, P4_LAP_ROUNDS,
         slab4, gs_counts["sparse"](P4_LAP_ROUNDS), False),
        ("banded_gs", "banded_gs", "allgather", banded, P4_BANDED_GS_ROUNDS,
         nb4, gs_counts["banded_gs"](P4_BANDED_GS_ROUNDS), True),
        ("halo_gs", "halo_gs", "halo", banded, P4_BANDED_GS_ROUNDS, nb4,
         gs_counts["halo_gs"](P4_BANDED_GS_ROUNDS), True),
        ("dense_gs", "dense_gs", "allgather", banded, P4_BANDED_GS_ROUNDS,
         nb4, gs_counts["dense_gs"](P4_BANDED_GS_ROUNDS), True))
    for name, kind, sync, prob, rounds, steps, expect, falls in p4_runs:
        tag = f"P = {P4} {name}, {rounds} rounds of {steps} local steps"
        res = p4[name]
        print(f"  {tag}: wall s per rank "
              + ", ".join(f"{wall:.3f}" for _, wall, _ in res["ranks"])
              + f" ({P4} CUDA contexts time-slicing one card: says nothing "
              "about scaling)", flush=True)
        for rank, (counts, _, _) in enumerate(res["ranks"]):
            check(counts == {name: expect.get(name, 0) for name in ops.KERNELS},
                  f"{tag}: rank {rank} launched exactly {expect}")
        if kind.endswith("_gs"):
            digests = {d for _, _, d in res["ranks"]}
            check(len(digests) == 1, f"{tag}: the returned x is bitwise the "
                  f"same on all {P4} ranks (SHA-256 {min(digests)[:16]})")
        resid = res["resid"]
        if falls:
            check(bool((resid[-1] < P4_FALL * resid[0]).all()),
                  f"{tag}: the residual falls {1 / P4_FALL:g}-fold (column 0 "
                  f"{float(resid[0, 0]):.4g} -> {float(resid[-1, 0]):.4g}, "
                  f"smallest fall {float((resid[0] / resid[-1]).min()):.4g}x)")
            x = res["x"].to(dev)
            relres = float((torch.linalg.vector_norm(prob.b - prob.A @ x,
                                                     dim=0)
                            / torch.linalg.vector_norm(prob.b, dim=0)).max())
            check(relres < P4_REL, f"{tag}: rank 0's final relative residual "
                  f"(dense torch.matmul) {relres:.3e} < {P4_REL:g}")
        else:
            check(bool(torch.isfinite(resid).all()
                       and (resid[-1] < resid[0]).all()),
                  f"{tag}: the residual is finite and falls (column 0 "
                  f"{float(resid[0, 0]):.4g} -> {float(resid[-1, 0]):.4g})")
        schedule_numbers(tag, res, kind, steps, P4, sync=sync,
                         a2a_schedule=lap_plan if sync == "a2a" else ())
        check(res["bytes_per_round"] > 0, f"{tag}: {sync} of "
              f"{res['bytes_per_round']:g} bytes per rank and round")
    check(len(lap_plan) == 2 and [s for s, _ in lap_plan] == [1, P4 - 1],
          f"laplacian_spd({FCG_SIDE}) in CSR at P = {P4}: slabs read their "
          f"neighbours only, {len(lap_plan)} rotations (offsets "
          f"{[s for s, _ in lap_plan]}), "
          f"{sum(len(pairs) for _, pairs in lap_plan)} sends a round")
    dense_graph = bool(ops_by[("spd", None)].slab_neighbors(P4).all())
    check(dense_graph and p4["sparse_gs"]["bytes_per_round"]
          == 4.0 * slab4 * K,
          f"the SPD problem's neighbor graph at P = {P4} is dense: "
          "sync='auto' resolved to a2a, which fell back to the all-gather "
          f"of 4 * {slab4} * {K} bytes a round")
    a2a, ag = p4["sparse_gs a2a"], p4["sparse_gs allgather"]
    check(all(torch.equal(a2a[f], ag[f]) for f in ("x", "resid"))
          and a2a["ranks"][0][2] == ag["ranks"][0][2],
          f"P = {P4} sparse_gs on the Laplacian: a2a's iterate and "
          "residuals bitwise the all-gather's, same picks")
    check(torch.equal(p4["halo_gs"]["x"], p4["banded_gs"]["x"]),
          f"P = {P4}: halo_gs's iterate bitwise banded_gs's, same picks")
    e = rel(p4["dense_gs"]["x"], p4["banded_gs"]["x"])
    check(e <= SWEEP_RTOL, f"P = {P4}: dense_gs and banded_gs, same block "
          f"picks: rel err of x {e:.3e} <= {SWEEP_RTOL:g}")
    p4_rest_checks(torch, ops, p4, lsq=lsq, banded=banded, spd=spd,
                   dense=dense, skew=skew, skew_csr=skew_csr,
                   band_csr=as_operator(banded.A, "csr"), smi=smi)
    del lap, lap_csr, skew, skew_csr

    def a_rel(prob, res):
        return float((res.err_sq[-1] / a_norm_sq(prob.A, prob.x_star)).mean())

    print(f"  mean relative A-norm error: CSR GS {a_rel(spd, gs):.4e} and "
          f"ELL GS {a_rel(spd, eg):.4e} after {GS_SWEEPS} sweeps, banded GS "
          f"{a_rel(banded, bg):.4e} after {BANDED_SWEEPS}, dense block GS "
          f"{a_rel(banded, dg):.4e} after {DENSE_SWEEPS}; RK mean relative "
          f"error after {RK_SWEEPS} sweeps: "
          f"{float((rk.err_sq[-1] / (lsq.x_star ** 2).sum(0)).mean()):.4e}",
          flush=True)

    print("== serving: SolverService over the CSR GS and RK problems",
          flush=True)
    serving_phase(torch, ops, spd, lsq, launches)

    print("== the sequential CLIs, the simulator, CG and the theory",
          flush=True)
    sequential_cli_phase(torch, ops, lsq, launches)

    print("== the paper's figures, the theorems and the examples", flush=True)
    paper_phase(torch, ops, spd, lsq, launches, smi)

    print(f"== timing (CUDA events, f32/i32 storage, k={K})", flush=True)
    lines = []

    def sweep_entry(name, op, run, run_plain, picks, source_line, **extra):
        """Time a row sweep beside its bound (``roofline.<name>`` on the
        picked rows' stored nonzeros and the operator's dtypes)."""
        ms = cuda_ms(run, 10)
        g_ms = graph_ms(run, 10)
        plain = cuda_ms(run_plain, 1)
        vals_, cols_ = op.padded_rows()
        work = getattr(roofline, name)(
            float(op.row_nnz[picks.long()].double().sum()), picks.numel(),
            op.shape[1], K, value_dtype=vals_.dtype, index_dtype=cols_.dtype)
        b_ms, by = bound_ms(work)
        print(f"  {name}: {ms:.4f} ms for {picks.numel()} picks "
              f"({ms * 1e3 / picks.numel():.4f} us/pick); plain "
              f"{plain:.2f} ms; bound {b_ms:.5f} ms ({by})", flush=True)
        lines.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/sweep_csr.cu",
            replaces=source_line, launches=launches[name],
            max_abs_err=errs[(name, None)], ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=by, library_ms=None, graph_ms=g_ms,
            **work_keys(work), **extra))

    # sweep_rows_gs: "ms" is the shared-memory path the wrapper takes at
    # this n, "global_ms" the global path on the same inputs (the bare
    # launcher told to take it).
    op = ops_by[("spd", None)]
    vals, cols = op.padded_rows()
    gs_picks32 = gs_picks.to(torch.int32)
    global_ms = cuda_ms(functools.partial(
        sweep_csr.sweep_rows_gs, vals, cols, spd.b, x_spd, gs_picks32,
        beta=1.0, write_base=0, limit=SPD_N, _shared=False), 10)
    print(f"  sweep_rows_gs global path: {global_ms:.4f} ms for {PREFIX} picks "
          f"({global_ms * 1e3 / PREFIX:.4f} us/pick)", flush=True)
    sweep_entry(
        "sweep_rows_gs", op,
        lambda: ops.sweep_rows_gs(vals, cols, spd.b, x_spd, gs_picks),
        lambda: ref.sweep_rows_gs_ref(vals, cols, spd.b, x_spd, gs_picks),
        gs_picks, "src/repro/kernels/sweep_csr.py:135", global_ms=global_ms,
        global_max_abs_err=errs["sweep_rows_gs_global"])
    # The RK sweeps likewise: "ms" is the shared-memory path the wrapper
    # takes at n = LSQ_N, "global_ms" the global path on the same inputs.
    op_l = ops_by[("lsq", None)]
    vals_l, cols_l = op_l.padded_rows()
    rn_l = op_l.row_norms_sq()
    global_ms = cuda_ms(functools.partial(
        sweep_csr.sweep_rows_rk, vals_l, cols_l, lsq.b, rn_l, x_lsq,
        rk_picks[None].to(torch.int32), beta=1.0, limit=LSQ_M,
        _shared=False), 10)
    print(f"  sweep_rows_rk global path: {global_ms:.4f} ms for {PREFIX} picks "
          f"({global_ms * 1e3 / PREFIX:.4f} us/pick)", flush=True)
    sweep_entry(
        "sweep_rows_rk", op_l,
        lambda: ops.sweep_rows_rk(vals_l, cols_l, lsq.b, rn_l, x_lsq,
                                  rk_picks[None]),
        lambda: ref.sweep_rows_rk_ref(vals_l, cols_l, lsq.b, rn_l, x_lsq,
                                      rk_picks[None]),
        rk_picks[None], "src/repro/kernels/sweep_csr.py:181",
        global_ms=global_ms,
        global_max_abs_err=errs["sweep_rows_rk_global"])

    # The two-carry sweep on rank 0's slab at P = 4 (its rows are the
    # operator's first, so op_l.row_nnz indexes them): bytes and flops as
    # sweep_rows_rk's, plus the delta carry in and out and its add.
    args, picks = rk_args["sweep_rows_rk_delta"]
    global_ms = cuda_ms(functools.partial(
        sweep_csr.sweep_rows_rk_delta, *args, x_lsq, d_lsq,
        picks.to(torch.int32), beta=1.0, limit=slab, _shared=False), 10)
    print(f"  sweep_rows_rk_delta global path: {global_ms:.4f} ms for {PREFIX} "
          f"picks ({global_ms * 1e3 / PREFIX:.4f} us/pick)", flush=True)
    sweep_entry(
        "sweep_rows_rk_delta", op_l,
        lambda: ops.sweep_rows_rk_delta(*args, x_lsq, d_lsq, picks),
        lambda: ref.sweep_rows_rk_delta_ref(*args, x_lsq, d_lsq, picks),
        picks, "src/repro/kernels/sweep_csr.py:258", global_ms=global_ms,
        global_max_abs_err=errs["sweep_rows_rk_delta_global"],
        **rest["extra"])
    full_delta = sample_rows(rn_l, LSQ_M, generator=gen)
    vals_f, cols_f = op_l.padded_rows()
    zero_l = torch.zeros_like(x_lsq)
    ms = cuda_ms(lambda: ops.sweep_rows_rk_delta(
        vals_f, cols_f, lsq.b, rn_l, x_lsq, zero_l, full_delta), 5)
    print(f"  sweep_rows_rk_delta, one P = 1 main-path round ({LSQ_M} "
          f"picks): {ms:.4f} ms ({ms * 1e3 / LSQ_M:.4f} us/pick)", flush=True)
    # the delta sweep's paths on that round in turns (shared, global,
    # global, shared)
    full_delta32 = full_delta.to(torch.int32)
    turns = [(shared, cuda_ms(functools.partial(
        sweep_csr.sweep_rows_rk_delta, vals_f, cols_f, lsq.b, rn_l, x_lsq,
        zero_l, full_delta32, beta=1.0, limit=LSQ_M, _shared=shared), 5))
        for shared in (True, False, False, True)]
    print("  sweep_rows_rk_delta P = 1 round by path, in turns (ms, us/pick): "
          + "; ".join(f"{'shared' if shared else 'global'} "
                      f"{t:.4f} ({t * 1e3 / LSQ_M:.4f})" for shared, t in turns),
          flush=True)

    # whole record chunks as the main path launches them
    full_gs = draw_picks(op, "gs", SPD_N, generator=gen)
    ms = cuda_ms(lambda: ops.sweep_rows_gs(vals, cols, spd.b, x_spd,
                                           full_gs), 5)
    print(f"  sweep_rows_gs, one main-path chunk ({SPD_N} picks): {ms:.4f} ms "
          f"({ms * 1e3 / SPD_N:.4f} us/pick)", flush=True)
    # the GS paths on that chunk in turns (shared, global, global, shared)
    full_gs32 = full_gs.to(torch.int32)
    turns = [(shared, cuda_ms(functools.partial(
        sweep_csr.sweep_rows_gs, vals, cols, spd.b, x_spd, full_gs32,
        beta=1.0, write_base=0, limit=SPD_N, _shared=shared), 5))
        for shared in (True, False, False, True)]
    print("  sweep_rows_gs main-path chunk by path, in turns (ms, us/pick): "
          + "; ".join(f"{'shared' if shared else 'global'} "
                      f"{t:.4f} ({t * 1e3 / SPD_N:.4f})" for shared, t in turns),
          flush=True)
    # The dispatch seam: the checked wrapper against the bare launcher on
    # the same chunk, in turns (wrapper, bare, bare, wrapper); and the
    # checks alone on the host clock with the card idle.
    wrapped = functools.partial(ops.sweep_rows_gs, vals, cols, spd.b, x_spd,
                                full_gs)
    bare = functools.partial(sweep_csr.sweep_rows_gs, vals, cols, spd.b, x_spd,
                             full_gs32, beta=1.0, write_base=0,
                             limit=SPD_N)
    w1, b1, b2, w2 = (cuda_ms(f, 5) for f in (wrapped, bare, bare, wrapped))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        ops._picks("seam", full_gs, SPD_N, x_spd)
    checks = (time.perf_counter() - t0) * 10        # ms per call
    print(f"  dispatch seam, sweep_rows_gs main-path chunk: wrapper "
          f"{w1:.4f}/{w2:.4f} ms, bare launch {b1:.4f}/{b2:.4f} ms, seam "
          f"{(w1 + w2 - b1 - b2) / 2:.4f} ms per launch; the checks alone "
          f"{checks:.4f} ms per call (host clock)", flush=True)
    full_rk = draw_picks(op_l, "rk", LSQ_M, generator=gen)
    ms = cuda_ms(lambda: ops.sweep_rows_rk(vals_l, cols_l, lsq.b, rn_l, x_lsq,
                                           full_rk), 5)
    print(f"  sweep_rows_rk, one main-path chunk ({LSQ_M} picks): {ms:.4f} ms "
          f"({ms * 1e3 / LSQ_M:.4f} us/pick)", flush=True)
    full_rk32 = full_rk.to(torch.int32)
    turns = [(shared, cuda_ms(functools.partial(
        sweep_csr.sweep_rows_rk, vals_l, cols_l, lsq.b, rn_l, x_lsq,
        full_rk32, beta=1.0, limit=LSQ_M, _shared=shared), 5))
        for shared in (True, False, False, True)]
    print("  sweep_rows_rk main-path chunk by path, in turns (ms, us/pick): "
          + "; ".join(f"{'shared' if shared else 'global'} "
                      f"{t:.4f} ({t * 1e3 / LSQ_M:.4f})" for shared, t in turns),
          flush=True)

    def library_spmv(op, x):
        """torch.sparse CSR product on the same nonzeros (the yardstick;
        the port never calls it)."""
        pv, pc = op.padded_rows()
        real = torch.arange(op.row_cap, device=dev)[None, :] < \
            op.row_nnz[:, None]
        crow = torch.zeros(op.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(op.row_nnz.long(), 0)
        with warnings.catch_warnings():     # "sparse CSR is in beta"
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(crow, pc[real].long(),
                                        pv[real].float(), size=op.shape)
        y = torch.sparse.mm(A, x)
        return (lambda: torch.sparse.mm(A, x)), y

    def spmv_entry(variant, op, x, err=None, source_line=None):
        """Time a CSR matvec kernel on ``op`` beside its bound.  Bytes:
        each stored nonzero's value and index (padding slots carry nothing
        this run needs), the per-row counts where the sliced pair is given
        them, each row's start and count for the segment sum (it reads no
        row id), x once, y once, and panel_nnz for the predicated twins;
        flops: 2 per nonzero per column.  With ``source_line`` it also times the plain
        version and the library yardstick (torch.sparse.mm on CSR) and
        returns the kernel's entry of the JSON line."""
        name, run, plain = csr_matvec(op, x, variant)
        ms = cuda_ms(run, 50)
        k = x.shape[1]
        shape = (op.nnz, *op.shape, k)
        dt = dict(value_dtype=op.data.dtype, index_dtype=op.indices.dtype)
        panels = op.panel_nnz().numel()
        counts = op.stop_counts(k) is not None
        work = {
            "sliced": lambda: roofline.spmv_csr_sliced(*shape, counts=counts,
                                                       **dt),
            "sliced_prefetch": lambda: roofline.spmv_csr_sliced_prefetch(
                *shape, panels, counts=counts, **dt),
            "segsum": lambda: roofline.spmv_csr(*shape, **dt),
            "segsum_prefetch": lambda: roofline.spmv_csr_prefetch(
                *shape, panels, **dt),
        }[variant]()
        b_ms, by = bound_ms(work)
        head = f"  {name} {op.shape} nnz={op.nnz}: {ms:.4f} ms"
        if source_line is None:
            print(f"{head}; bound {b_ms:.5f} ms ({by})", flush=True)
            return None
        plain_ms = cuda_ms(plain, 5)
        lib, y_lib = library_spmv(op, x)
        check(torch.allclose(y_lib, run(), rtol=1e-4, atol=1e-4),
              f"{name}: torch.sparse.mm agrees with the kernel")
        lib_ms = cuda_ms(lib, 50)
        print(f"{head}; plain {plain_ms:.4f} ms; torch.sparse.mm "
              f"{lib_ms:.4f} ms; bound {b_ms:.5f} ms ({by})", flush=True)
        return dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/spmv_csr.cu",
                    replaces=source_line, launches=launches[name],
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=by, library_ms=lib_ms, graph_ms=graph_ms(run, 50),
                    **work_keys(work))

    lines.append(spmv_entry("sliced", ops_by[("spd", None)], x_spd,
                            errs[("spmv_csr_sliced", None, "spd")],
                            "src/repro/kernels/spmv_csr.py:271"))
    spmv_entry("sliced", ops_by[("lsq", None)], x_lsq)
    lines.append(spmv_entry("sliced_prefetch", holes, x_lsq,
                            errs["prefetch_holes"],
                            "src/repro/kernels/spmv_csr.py:327"))

    # ELL matvec: the SPD problem's ELL operator; its library yardstick is
    # torch.sparse.mm on CSR over the same nonzeros.  Bytes: the stored
    # entries' values and indices (the kernel stops each row after its
    # first padding slot, and the padding carries nothing this run needs),
    # the per-row counts, x once, y once; flops: 2 per nonzero per column.
    op = ops_by[("ell", None)]
    run = functools.partial(ops.spmv_ell, op.vals, op.cols, x_spd,
                            counts=op.stop_counts(K))
    ms = cuda_ms(run, 50)
    plain_ms = cuda_ms(functools.partial(ref.spmv_ell_ref, op.vals, op.cols,
                                         x_spd), 5)
    lib, y_lib = library_spmv(ops_by[("spd", None)], x_spd)
    check(torch.allclose(y_lib, run(), rtol=1e-4, atol=1e-4),
          "spmv_ell: torch.sparse.mm agrees with the kernel")
    lib_ms = cuda_ms(lib, 50)
    nnz = ops_by[("spd", None)].nnz
    stored = int(op.row_counts().sum())
    work = roofline.spmv_ell(stored, SPD_N, SPD_N, K, counts=True,
                             value_dtype=op.vals.dtype,
                             index_dtype=op.cols.dtype)
    b_ms, by = bound_ms(work)
    print(f"  spmv_ell n={SPD_N} width={ell_width} nnz={nnz}: {ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; torch.sparse.mm {lib_ms:.4f} ms; bound "
          f"{b_ms:.5f} ms ({by})", flush=True)
    lines.append(dict(name="spmv_ell", route="cuda",
                      source="src/repro_torch/csrc/spmv_ell.cu",
                      replaces="src/repro/kernels/spmv_ell.py:46",
                      launches=launches["spmv_ell"],
                      max_abs_err=errs[("spmv_ell", None)], ms=ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      library_ms=lib_ms, graph_ms=graph_ms(run, 50),
                      **work_keys(work)))

    # bbmv: the banded operator's tiles.  Bytes: the tiles inside the
    # matrix (the kernel never reads the others), x once, y once; flops:
    # 2 * block^2 * k per such tile.  Library yardstick: torch.sparse BSR
    # with the same 128 x 128 blocks.
    op = ops_by[("banded", None)]
    run = functools.partial(ops.bbmv, op.A_bands, x_band, bands=BANDS,
                            block=BLOCK)
    ms = cuda_ms(run, 50)
    plain_ms = cuda_ms(functools.partial(ref.bbmv_ref, op.A_bands, x_band,
                                         bands=BANDS, block=BLOCK), 3)
    tiles = int(ref.band_valid(nb, BANDS, dev).sum())
    work = roofline.bbmv(tiles, BLOCK, SPD_N, K,
                         value_dtype=op.A_bands.dtype)
    b_ms, by = bound_ms(work)
    # Only PyTorch's own calls sit in the try: a PyTorch build without a
    # CUDA BSR product for f32 raises there, and that alone makes the
    # yardstick null.  The agreement check and the timing stay outside,
    # so a mismatch or a failed launch still ends the run.
    A_bsr, lib_ms = None, None
    try:
        with warnings.catch_warnings():     # "sparse BSR is in beta"
            warnings.simplefilter("ignore", UserWarning)
            A_bsr = banded.A.to_sparse_bsr((BLOCK, BLOCK))
            y_lib = A_bsr @ x_band
    except (RuntimeError, NotImplementedError) as e:
        A_bsr = None
        lib_note = f"torch.sparse BSR not available here ({str(e)[:120]})"
    if A_bsr is not None:
        check(torch.allclose(y_lib, run(), rtol=1e-4, atol=1e-4),
              "bbmv: torch.sparse BSR matmul agrees with the kernel")
        lib_ms = cuda_ms(lambda: A_bsr @ x_band, 50)
        lib_note = f"torch.sparse BSR {lib_ms:.4f} ms"
    print(f"  bbmv nb={nb} block={BLOCK} bands={BANDS} ({tiles} tiles): "
          f"{ms:.4f} ms; plain {plain_ms:.4f} ms; {lib_note}; bound "
          f"{b_ms:.5f} ms ({by})", flush=True)
    lines.append(dict(name="bbmv", route="cuda",
                      source="src/repro_torch/csrc/bbmv.cu",
                      replaces="src/repro/kernels/bbmv.py:53",
                      launches=launches["bbmv"],
                      max_abs_err=errs[("bbmv", None)], ms=ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      library_ms=lib_ms, graph_ms=graph_ms(run, 50),
                      **work_keys(work)))

    # banded_gs_sweep: one main-path chunk (nb picks).  Bytes, by the
    # sweeps' rule: per pick its 2*bands+1 tiles, its b block and its id,
    # plus the window once in and once out; flops: 2 * block^2 * k per
    # tile read.  No library call computes this serial chain.
    # "ms" is the shared-memory path the wrapper takes at this window,
    # "global_ms" the global path on the same inputs (the bare launcher
    # told to take it).
    packed = op.packed_band_tiles()
    run = functools.partial(ops.banded_gs_sweep, packed, banded.b, xw_band,
                            band_picks, block=BLOCK, bands=BANDS)
    ms = cuda_ms(run, 10)
    g_ms = graph_ms(run, 10)
    global_ms = cuda_ms(functools.partial(
        _banded.banded_gs_sweep, packed, banded.b, xw_band, band_picks32,
        block=BLOCK, bands=BANDS, beta=1.0, limit=nb, _shared=False), 10)
    plain_ms = cuda_ms(functools.partial(
        ref_banded.banded_gs_sweep_ref, packed, banded.b, xw_band,
        band_picks, block=BLOCK, bands=BANDS), 1)
    work = roofline.banded_gs_sweep(nb, BLOCK, BANDS, xw_band.shape[0], K,
                                    value_dtype=packed.dtype)
    b_ms, by = bound_ms(work)
    print(f"  banded_gs_sweep, one main-path chunk ({nb} picks): {ms:.4f} ms "
          f"({ms * 1e3 / nb:.3f} us/pick); global path {global_ms:.4f} ms; "
          f"plain {plain_ms:.2f} ms; bound {b_ms:.5f} ms ({by}); no library "
          "call", flush=True)
    lines.append(dict(name="banded_gs_sweep", route="cuda",
                      source="src/repro_torch/csrc/banded_gs.cu",
                      replaces="src/repro/kernels/banded_gs.py:93",
                      launches=launches["banded_gs_sweep"],
                      max_abs_err=errs[("banded_gs_sweep", None)], ms=ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      library_ms=None, graph_ms=g_ms, global_ms=global_ms,
                      **work_keys(work)))

    # banded_rk_sweep: the P = 4 check round (rank 1's window, mixed
    # gates) and one P = 1 main-path round (nb picks, every gate 1, on the
    # whole problem's window), each with its global path ("global_ms").  A
    # pick whose gate is 0 leaves both windows as they were, so the least
    # work these inputs need is the owned picks': per such pick its tiles,
    # b block, row norms, id and gate, and 2 * 2 * block^2 * k flops per
    # tile read (A x, then A^T gn); both windows once in and once out.  No
    # library call computes this serial chain.
    def rk_work(owned, tiles, window):
        return roofline.banded_rk_sweep(owned, BLOCK, BANDS, window.shape[0],
                                        K, value_dtype=tiles.dtype)

    args, xw = rk_args["banded_rk_sweep"]
    run = functools.partial(ops.banded_rk_sweep, *args, xw, dw_band, lic,
                            gates, block=BLOCK, bands=BANDS)
    ms = cuda_ms(run, 10)
    g_ms = graph_ms(run, 10)
    global_ms = cuda_ms(functools.partial(
        _banded.banded_rk_sweep, *args, xw, dw_band, lic32, gates,
        block=BLOCK, bands=BANDS, beta=1.0, limit=nb_local, _shared=False),
        10)
    plain_ms = cuda_ms(functools.partial(
        ref_banded.banded_rk_sweep_ref, *args, xw, dw_band, lic, gates,
        block=BLOCK, bands=BANDS), 1)
    owned = int(gates.sum())
    work = rk_work(owned, args[0], xw)
    b_ms, by = bound_ms(work)
    print(f"  banded_rk_sweep, one P = {P4} round ({P4_BANDED_STEPS} picks, "
          f"{owned} owned): {ms:.4f} ms ({ms * 1e3 / P4_BANDED_STEPS:.3f} "
          f"us/pick); global path {global_ms:.4f} ms; plain {plain_ms:.2f} "
          f"ms; bound {b_ms:.5f} ms ({by}); no library call", flush=True)
    op = ops_by[("banded", None)]
    rn_all = op.row_norms_sq()
    rn_all = torch.where(rn_all > 0, rn_all, 1.0)
    rk_round = sample_rows(panel_w, nb, generator=gen)
    ones = torch.ones_like(rk_round, dtype=torch.int32)
    p1_args = (op.packed_band_tiles(), banded.b, rn_all, xw_band,
               torch.zeros_like(xw_band), rk_round)
    ms_p1 = cuda_ms(lambda: ops.banded_rk_sweep(
        *p1_args, ones, block=BLOCK, bands=BANDS), 5)
    global_p1 = cuda_ms(lambda: _banded.banded_rk_sweep(
        *p1_args[:-1], rk_round.to(torch.int32), ones, block=BLOCK,
        bands=BANDS, beta=1.0, limit=nb, _shared=False), 5)
    b_p1, by_p1 = bound_ms(rk_work(nb, p1_args[0], xw_band))
    print(f"  banded_rk_sweep, one P = 1 main-path round ({nb} picks, all "
          f"owned): {ms_p1:.4f} ms ({ms_p1 * 1e3 / nb:.3f} us/pick); global "
          f"path {global_p1:.4f} ms; bound {b_p1:.5f} ms ({by_p1})",
          flush=True)
    lines.append(dict(name="banded_rk_sweep", route="cuda",
                      source="src/repro_torch/csrc/banded_gs.cu",
                      replaces="src/repro/kernels/banded_gs.py:191",
                      launches=launches["banded_rk_sweep"],
                      max_abs_err=errs[("banded_rk_sweep", None)], ms=ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      library_ms=None, graph_ms=g_ms, global_ms=global_ms,
                      **work_keys(work), p1_ms=ms_p1,
                      p1_global_ms=global_p1, p1_bound_ms=b_p1,
                      p1_bound_by=by_p1))

    # block_gs_sweep: one main-path chunk (nb picks of BLOCK-row panels).
    # Bytes, by the sweeps' rule: per pick its (BLOCK, n) row panel, its b
    # block and its id, plus x once in and once out; flops: 2 * BLOCK * n
    # * k per pick for the panel product and 3 * BLOCK * k for the update.
    # No library call computes this serial chain; one step's panel product
    # by torch.matmul is timed for context.
    A_dense = banded.A
    run = functools.partial(ops.block_gs_sweep, A_dense, banded.b, x_band,
                            dense_picks, block=BLOCK)
    ms = cuda_ms(run, 5)
    block_gs_run = run      # replayed from a graph last (below)
    A_bf16 = A_dense.to(torch.bfloat16)
    ms_bf16 = cuda_ms(functools.partial(ops.block_gs_sweep, A_bf16, banded.b,
                                        x_band, dense_picks, block=BLOCK), 5)
    del A_bf16
    plain_ms = cuda_ms(functools.partial(
        ref.block_gs_sweep_ref, A_dense, banded.b, x_band, dense_picks,
        block=BLOCK), 1)
    work = roofline.block_gs_sweep(nb, BLOCK, SPD_N, K,
                                   value_dtype=A_dense.dtype)
    b_ms, by = bound_ms(work)
    panel = A_dense[:BLOCK]
    props = torch.cuda.get_device_properties(dev)
    bgs_limits = (props.multi_processor_count,
                  props.shared_memory_per_block_optin)
    mm_ms = cuda_ms(lambda: panel @ x_band, 20)
    # One record of the dense path: record_metrics' two products with the
    # dense A (torch.matmul, as in the reference) and its column sums.
    rec_ms = cuda_ms(lambda: record_metrics(
        DenseOp(A_dense), banded.b, x_band, banded.x_star, norm="A"), 5)
    print(f"  dense path: one record (two torch.matmul with the dense A) "
          f"{rec_ms:.4f} ms; {dg.iters.numel()} records per solve",
          flush=True)
    # The same record of one column: its products still go through one
    # DENSE_MATVEC_COLUMNS-wide GEMM each (the column groups), next to one
    # plain matrix-vector product A @ x[:, :1], which a record without the
    # groups would make twice.
    x1 = x_band[:, :1].contiguous()
    rec1_ms = cuda_ms(lambda: record_metrics(
        DenseOp(A_dense), banded.b[:, :1].contiguous(), x1,
        banded.x_star[:, :1].contiguous(), norm="A"), 5)
    gemv_ms = cuda_ms(lambda: A_dense @ x1, 5)
    print(f"  dense path: one record at k=1 {rec1_ms:.4f} ms (k={K}: "
          f"{rec_ms:.4f} ms); one A @ x[:, :1] without the column groups "
          f"{gemv_ms:.4f} ms", flush=True)
    print(f"  block_gs_sweep, one main-path chunk ({nb} picks, n={SPD_N}, "
          f"block={BLOCK}): {ms:.4f} ms ({ms * 1e3 / nb:.3f} us/pick; bf16 A "
          f"{ms_bf16:.4f} ms, {ms_bf16 * 1e3 / nb:.3f} us/pick); plain "
          f"{plain_ms:.2f} ms; bound {b_ms:.5f} ms ({by}, "
          f"{b_ms * 1e3 / nb:.3f} us/pick); no library call (a serial "
          f"chain); one step's panel product by torch.matmul "
          f"{mm_ms * 1e3:.3f} us; plan "
          f"{_block_gs.c_plan(SPD_N, BLOCK, K, 4, *bgs_limits)}", flush=True)
    lines.append(dict(name="block_gs_sweep", route="cuda",
                      source="src/repro_torch/csrc/block_gs.cu",
                      replaces="src/repro/kernels/block_gs.py:84",
                      launches=launches["block_gs_sweep"],
                      max_abs_err=errs[("block_gs_sweep", None)], ms=ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      library_ms=None, us_per_pick=ms * 1e3 / nb,
                      bf16_ms=ms_bf16, **work_keys(work)))

    # sweep_rows_block_gs: one main-path chunk at the last of
    # CSR_BGS_BLOCKS (a sweep: SPD_N // block picks).  Bytes, by the
    # sweeps' rule: per pick its rows' stored nonzeros (value and index),
    # their b rows and its id, plus x once in and once out; flops: 2 * nnz
    # * k + 3 * k a row.  No library call computes this serial chain.
    blk = CSR_BGS_BLOCKS[-1]
    chunk = csr_bgs_out["chunks"][blk]
    op_b = csr_bgs_out["op"]
    vals_b, cols_b = op_b.padded_rows()
    rows_b = (chunk["picks"].long()[:, None] * blk
              + torch.arange(blk, device=dev)[None, :]).reshape(-1)
    work = roofline.sweep_rows_block_gs(
        float(op_b.row_nnz[rows_b].double().sum()), rows_b.numel(),
        chunk["picks"].numel(), SPD_N, K, value_dtype=vals_b.dtype,
        index_dtype=cols_b.dtype)
    b_ms, by = bound_ms(work)
    plain_ms = cuda_ms(functools.partial(
        ref.sweep_rows_block_gs_ref, vals_b, cols_b, spd.b, csr_bgs_out["x0"],
        chunk["picks"], block=blk), 1)
    print(f"  sweep_rows_block_gs, one main-path chunk (block {blk}, "
          f"{chunk['picks'].numel()} picks): {chunk['ms']:.4f} ms from "
          f"Python ({chunk['ms'] * 1e3 / chunk['picks'].numel():.3f} "
          f"us/pick); plain {plain_ms:.2f} ms; bound {b_ms:.5f} ms ({by}); "
          f"no library call (a serial chain) [{smi}]", flush=True)
    small = csr_bgs_out["chunks"][CSR_BGS_BLOCKS[0]]
    lines.append(dict(name="sweep_rows_block_gs", route="cuda",
                      source="src/repro_torch/csrc/sweep_csr.cu",
                      replaces="none: a kernel of the port's own (the "
                      "reference runs block GS on CSR as a lax.scan over "
                      "densified row panels, src/repro/core/engine.py:580-590, "
                      "no Pallas kernel)",
                      launches=launches["sweep_rows_block_gs"],
                      max_abs_err=csr_bgs_out["errs"][(None, blk)], ms=chunk["ms"],
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      library_ms=None, graph_ms=chunk["graph_ms"], block=blk,
                      global_ms=chunk["turns"][1], **work_keys(work),
                      **{f"block{CSR_BGS_BLOCKS[0]}_ms": small["ms"],
                         f"block{CSR_BGS_BLOCKS[0]}_graph_ms":
                             small["graph_ms"]}))

    # The segment-sum pair on both operators; the JSON line takes each
    # kernel on the operator of its main-path run.
    lines.append(spmv_entry("segsum", ops_by[("spd", None)], x_spd,
                            errs[("spmv_csr", None, "spd")],
                            "src/repro/kernels/spmv_csr.py:121"))
    spmv_entry("segsum", holes, x_lsq)
    lines.append(spmv_entry("segsum_prefetch", holes, x_lsq,
                            errs[("spmv_csr_prefetch", None, "holes")],
                            "src/repro/kernels/spmv_csr.py:187"))
    spmv_entry("segsum_prefetch", ops_by[("spd", None)], x_spd)

    # colsum: the record sums of the CSR GS path's shape (n = SPD_N rows, K
    # columns).  Bytes: t once, the sums once; operations: one add per
    # element.  The library call is torch.sum over the rows, which the
    # plain version also reaches through a transposed copy.
    t_rec = x_spd * x_spd
    ms = cuda_ms(functools.partial(ops.colsum, t_rec), 50)
    plain_ms = cuda_ms(functools.partial(ref.colsum_ref, t_rec), 50)
    lib_ms = cuda_ms(functools.partial(torch.sum, t_rec, 0), 50)
    work = roofline.colsum(*t_rec.shape)
    b_ms, by = bound_ms(work)
    print(f"  colsum n={SPD_N} k={K}: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"torch.sum {lib_ms:.4f} ms; bound {b_ms:.5f} ms ({by})", flush=True)
    colsum_graph = graph_ms(functools.partial(ops.colsum, t_rec), 50)
    lib_graph = graph_ms(functools.partial(torch.sum, t_rec, 0), 50)
    print(f"  torch.sum n={SPD_N} k={K} from a CUDA graph: {lib_graph:.4f} ms",
          flush=True)
    lines.append(dict(name="colsum", route="cuda",
                      source="src/repro_torch/csrc/colsum.cu",
                      replaces="none: a kernel of the port's own (the record "
                      "sums of src/repro/core/engine.py:322-326 are jnp, no "
                      "Pallas kernel)",
                      launches=launches["colsum"], max_abs_err=errs["colsum"],
                      ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      library_ms=lib_ms, graph_ms=colsum_graph,
                      **work_keys(work)))

    # Each kernel's call replayed from one CUDA graph ("graph_ms", taken
    # beside "ms" above): the card's time with the host's launch work (the
    # checks in kernels/ops.py, the ctypes call, the output's allocation)
    # taken out.  The dense block-GS sweep, one cooperative launch, is
    # captured last.
    print("== timing from CUDA graphs", flush=True)
    for entry in lines:
        if entry["name"] == "block_gs_sweep":
            entry["graph_ms"] = graph_ms(block_gs_run, 5)
        g = entry["graph_ms"]
        print(f"  {entry['name']}: {entry['ms']:.4f} ms from Python, "
              f"{g:.4f} ms from a graph ({100 * g / entry['ms']:.0f}% of it "
              "the card's)", flush=True)

    left = live_children()
    check(not left, "no process this run started is still running "
          f"(children: {left or 'none'})")
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s wall, the "
          "kernels' build included", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
