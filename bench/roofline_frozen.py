"""The yardstick of the roofline metrics: published peaks and the work of
each kernel the cells time, counted from shapes and from the picks a run
made, never from the code that implements them.

A frozen copy (``repro_torch/roofline.py`` holds the program's own), so
that a change to the program cannot move the yardstick.  A kernel's bound
is the least time the card could take for its work::

    bound_s = max(bytes / HBM rate, f32 flops / f32 rate)

Bytes count each input byte read once and each output byte written once.
A sweep is a launch of one record's picks: it must read the stored
nonzeros (value and index, 8 bytes) and the b row of every distinct row it
picks, each pick id, and the iterate once in and once out.  Its flops are
per pick: 2 a stored nonzero and column for the dot, 3 a row and column
for the update.  A byte bound does not bound a serial chain of picks, so
the sweeps' shares stay far below 100%; they still move with the kernel's
time.
"""
from __future__ import annotations

from dataclasses import dataclass

F32 = 4
INDEX = 4
ENTRY = 8          # a stored nonzero: float32 value and int32 column


@dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float
    f32_flops_per_s: float


#: By ``torch.cuda.get_device_name()``: one H100 SXM at its full 700 W
#: (NVIDIA's data sheet): HBM3 at 3.35 TB/s, 67 TFLOP/s of float32 outside
#: the tensor cores.
PEAKS = {"NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12)}


@dataclass(frozen=True)
class Work:
    bytes: float
    flops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)


def bound_s(work: Work, device_name: str) -> float | None:
    """The least seconds the card takes for ``work``; None for a card
    without published peaks here."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    return max(work.bytes / p.hbm_bytes_per_s, work.flops / p.f32_flops_per_s)


def sweep_rows_gs(*, distinct_nnz, distinct_rows, picks, stream_nnz, n,
                  k) -> Work:
    """Coordinate GS: ``picks`` picks of ``distinct_rows`` distinct rows
    holding ``distinct_nnz`` stored nonzeros; ``stream_nnz`` sums the
    picked rows' nonzeros pick by pick."""
    return Work(distinct_nnz * ENTRY + distinct_rows * k * F32 + picks * INDEX
                + 2 * n * k * F32,
                2.0 * stream_nnz * k + 3.0 * picks * k)


def sweep_rows_block_gs(*, distinct_nnz, distinct_blocks, picks, stream_nnz,
                        n, k, block) -> Work:
    """Block GS: ``picks`` picks of aligned panels of ``block`` rows,
    ``distinct_blocks`` distinct, holding ``distinct_nnz`` stored nonzeros;
    ``stream_nnz`` sums the picked panels' nonzeros pick by pick."""
    return Work(distinct_nnz * ENTRY + distinct_blocks * block * k * F32
                + picks * INDEX + 2 * n * k * F32,
                2.0 * stream_nnz * k + 3.0 * picks * block * k)


def spmv_csr(*, nnz, m, n, k) -> Work:
    """A x over an (m, n) operator of ``nnz`` stored nonzeros: each once,
    x once in, y once out; 2 flops a nonzero and column."""
    return Work(nnz * ENTRY + n * k * F32 + m * k * F32, 2.0 * nnz * k)


def colsum(*, n, k) -> Work:
    """Column sums of an (n, k) float32 tensor: it once, k sums out, an
    add an element."""
    return Work(n * k * F32 + k * F32, float(n * k))
