"""Matrix formats of the solver engine (port of ``repro/core/operators.py``:
dense, block-banded, ELL and CSR).

Operators are plain classes holding tensors on one device.  They answer
what the engine's actions need:

* ``matvec(x)``        — full ``A @ x`` (the format's matvec kernel on the
                         card, its plain version on the CPU);
* ``row_norms_sq()``   — per-row ``||A_r||^2`` in f32;
* ``gs_sweep`` / ``rk_sweep`` — a whole run of picks, one coordinate-GS or
                         Kaczmarz step each (sparse formats: one kernel
                         launch); the block-banded format steps whole
                         block rows and has no sequential Kaczmarz sweep;
* ``block_gs_sweep``   — (dense and CSR) a whole run of aligned block-row
                         GS steps, one kernel launch.

The distributed engine's layout queries: ``halo_width`` (how far a row
reads from itself: ``bands * block`` on the block-banded format, ``None``
elsewhere), ``slab_neighbors(P)`` on CSR and ELL (which row slab reads
which column slab, ``slab_neighbor_matrix``) and, for the banded records,
``BlockBandedOp.window_tiles`` with ``banded_window_matvec``; ``nnz_cost()``
on every format (the stored coefficients a full read touches) and
``CsrOp.row_reach()`` (each row's reach).  The reference's per-step shard
helpers (``banded_panel_residual`` and its kin) have no port: the local
phases are whole-round kernels.  Nor has its ``shard_spec`` (a
``shard_map`` ``PartitionSpec``): a rank of the distributed engine takes
its slab of an operator by slicing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spd import ell_from_dense
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bbmv import dense_to_bands, pack_bands_local
from repro_torch.kernels.spmv_csr import row_extent, worth_stopping
from repro_torch.tune import runtime as tune_runtime
from repro_torch.tune.table import MATVEC_VARIANTS

__all__ = ["BlockBandedOp", "CsrOp", "DenseOp", "EllOp", "as_operator",
           "banded_window_matvec", "canonical_storage_dtype",
           "slab_neighbor_matrix"]

# The storage-precision axis (DESIGN.md §7): coefficients may be held in
# bf16 while row norms, sampling and the iterate stay f32; the kernels
# widen on load and accumulate in f32.  ``None`` keeps the input dtype.
STORAGE_DTYPES = ("float32", "bfloat16")

def canonical_storage_dtype(storage_dtype):
    """Validate/normalize a ``storage_dtype`` argument to a torch dtype.

    ``None`` -> None (keep the input dtype).
    """
    if storage_dtype is None:
        return None
    name = (storage_dtype if isinstance(storage_dtype, str)
            else str(storage_dtype).removeprefix("torch."))
    if name not in STORAGE_DTYPES:
        raise ValueError(
            f"unknown storage_dtype: {storage_dtype!r} "
            f"(choose from {STORAGE_DTYPES})")
    return getattr(torch, name)


def _index_dtype(values_dtype, n: int):
    """Column-index dtype paired with a value dtype: low-precision values
    narrow the index stream to int16 when every column id fits, halving
    the index bytes alongside the value bytes."""
    if values_dtype.itemsize < 4 and n <= torch.iinfo(torch.int16).max:
        return torch.int16
    return torch.int32


def _per_panel(counts: torch.Tensor, rows_per_panel: int) -> torch.Tensor:
    """(num_panels, rows_per_panel) int64 view of per-row counts,
    zero-padded to whole panels, on the counts' device."""
    m, R = counts.shape[0], rows_per_panel
    padded = torch.zeros((-(-m // R) * R,), dtype=torch.int64,
                         device=counts.device)
    padded[:m] = counts
    return padded.view(-1, R)


def _layout_scalars(counts: torch.Tensor, rows_per_panel: int):
    """(count of nonzeros, largest row count, largest panel count) of a
    CSR layout's per-row counts, in one host read; zeros for no rows."""
    if not counts.numel():
        return 0, 0, 0
    return tuple(torch.stack([
        counts.sum(), counts.max(),
        _per_panel(counts, rows_per_panel).sum(1).max()]).tolist())


def slab_neighbor_matrix(rows: torch.Tensor, cols: torch.Tensor,
                         real: torch.Tensor, m: int, n: int,
                         num_workers: int) -> np.ndarray:
    """Host-side neighbor graph of a row-slab partition.

    ``need[w, v]`` is True when worker ``w``'s rows (slab ``[w*m/P,
    (w+1)*m/P)``) read at least one coefficient owned by worker ``v``
    (column slab ``[v*n/P, (v+1)*n/P)``); the diagonal is always True.
    ``rows``/``cols``/``real`` give each stored slot's row, column and
    whether it holds a nonzero, on any one device: the P x P matrix is
    filled there and read back once.  The distributed engine's
    ``sync="a2a"`` builds its rotations from it.
    """
    if m % num_workers or n % num_workers:
        raise ValueError(
            f"worker count ({num_workers}) must divide rows ({m}) and "
            f"columns ({n}) for a slab partition")
    w = rows.reshape(-1).long() // (m // num_workers)
    v = cols.reshape(-1).long() // (n // num_workers)
    hits = torch.zeros(num_workers * num_workers, dtype=torch.int64,
                       device=real.device)
    hits.index_add_(0, w * num_workers + v, real.reshape(-1).long())
    need = (hits > 0).view(num_workers, num_workers).cpu().numpy().copy()
    np.fill_diagonal(need, True)
    return need


def window_norms_sq(vals: torch.Tensor) -> torch.Tensor:
    """Per-row sum of squares of (rows, width) windows in f32, each row's
    terms added left to right over its slots: the order of the
    reference's sums on the CPU (the CSR segment sum, the ELL einsum), so
    the row norms, and the sampling and the balanced partition built on
    them, are bitwise the reference's.  Padding slots hold 0 and add
    nothing; a row's sum is the same from run to run on the card too."""
    sq = vals.float() * vals.float()
    acc = sq[:, 0].clone() if sq.shape[1] else sq.sum(1)
    for j in range(1, sq.shape[1]):
        acc = acc + sq[:, j]
    return acc


def banded_window_matvec(tiles: torch.Tensor, vw: torch.Tensor, *,
                         bands: int, block: int) -> torch.Tensor:
    """``(A v)`` for a run of block rows from their halo-padded window
    ``vw`` (``slab + 2 * bands * block`` rows), one ``bbmv`` launch.

    ``tiles`` is ``BlockBandedOp.window_tiles`` of those block rows: their
    packed tiles between ``bands`` zero block rows a side, so that ``bbmv``
    over the window reads every tile of the owned rows and computes zeros
    for the halo's.  Returns the owned rows, (slab, k)."""
    halo = bands * block
    y = ops.bbmv(tiles, vw, bands=bands, block=block)
    return y[halo:y.shape[0] - halo]


# Columns of one dense matvec product.  cuBLAS picks its kernel, and with
# it the order of every sum, by shape (at one column a matrix-vector
# product), so x is cut into groups of this width, the last zero-padded:
# every column goes through one GEMM shape, and a column's A·x does not
# depend on how many columns ride along.  64 holds the paper's 51 RHS in
# one group.
DENSE_MATVEC_COLUMNS = 64


class DenseOp:
    """Dense row-major operator — square SPD or rectangular (m, n).  Its
    matvec is plain ``torch.matmul`` in fixed column groups (the reference
    leaves it to XLA); its block-GS sweep is the ``block_gs_sweep``
    kernel."""

    def __init__(self, A: torch.Tensor):
        self.A = A

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.A.shape)

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def halo_width(self):
        """Dense rows read every column: no finite halo."""
        return None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        A = self.A.to(x.dtype)
        G = DENSE_MATVEC_COLUMNS
        k = x.shape[1]
        if k == 0:
            return A @ x
        groups = -(-k // G)
        xp = torch.nn.functional.pad(x, (0, groups * G - k))
        y = torch.cat([A @ xp[:, g * G:(g + 1) * G].contiguous()
                       for g in range(groups)], 1)
        return y[:, :k].contiguous()

    def row_norms_sq(self) -> torch.Tensor:
        """Per-row ||A_i||² — always f32."""
        A = self.A.float()
        return (A * A).sum(1)

    def gs_sweep(self, b, x, picks, *, beta: float = 1.0) -> torch.Tensor:
        """Sequential coordinate-GS steps, one per pick, in the reference's
        scan arithmetic (``x[r] += beta * (b[r] - A[r] @ x)``); returns a
        new x.  There is no kernel for it: each step is a few PyTorch
        calls."""
        x = x.clone()
        for r in picks.tolist():
            x[r] += beta * (b[r] - self.A[r].to(x.dtype) @ x)
        return x

    def rk_sweep(self, b, rn, x, picks, *, beta: float = 1.0) -> torch.Tensor:
        """Sequential Kaczmarz steps, one per pick, in the reference's scan
        arithmetic (``g = (b[r] - A[r] @ x) / rn[r]``, then
        ``x += beta * A[r] * g`` with the row widened to f32); returns a
        new x."""
        x = x.clone()
        for r in picks.tolist():
            g = (b[r] - self.A[r].to(x.dtype) @ x) / rn[r]
            x += beta * self.A[r].float()[:, None] * g[None, :]
        return x

    def nnz_cost(self) -> int:
        m, n = self.A.shape
        return m * n

    def block_gs_sweep(self, b, x, blocks, *, block: int,
                       beta: float = 1.0) -> torch.Tensor:
        """Sequential randomized block-GS steps, one per block id ``bi``:
        ``x[B] += beta * (b[B] - A[B, :] @ x)`` on the rows
        ``B = [bi * block, (bi + 1) * block)``; one launch of the block-GS
        kernel on the card, its plain version on the CPU.  Returns a new
        x."""
        return ops.block_gs_sweep(self.A, b, x, blocks, block=block,
                                  beta=beta)

    def to_dense(self) -> torch.Tensor:
        return self.A


class BlockBandedOp:
    """Block-banded operator: tiles ``A_bands[nb, 2*bands+1, block, block]``
    (``kernels/bbmv.py``), tile ``d`` of block row ``i`` at block column
    ``i + d - bands``; tiles outside the matrix are zero.  A block row only
    reads x within ``bands * block`` rows of itself."""

    def __init__(self, A_bands: torch.Tensor, *, bands: int):
        self.A_bands = A_bands
        self.bands = bands
        self._packed: torch.Tensor | None = None

    @classmethod
    def from_dense(cls, A: torch.Tensor, *, block: int, bands: int,
                   storage_dtype=None) -> "BlockBandedOp":
        """The block band of dense ``A``, packed on A's device; entries
        outside the band are dropped."""
        tiles = dense_to_bands(A, bands=bands, block=block)
        dt = canonical_storage_dtype(storage_dtype)
        if dt is not None:
            tiles = tiles.to(dt)
        return cls(tiles, bands=bands)

    @property
    def nb(self) -> int:
        return self.A_bands.shape[0]

    @property
    def block(self) -> int:
        return self.A_bands.shape[2]

    @property
    def width(self) -> int:
        return self.A_bands.shape[1]

    @property
    def n(self) -> int:
        return self.nb * self.block

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def device(self) -> torch.device:
        return self.A_bands.device

    @property
    def halo_width(self) -> int:
        """Rows a block row reads either side of itself."""
        return self.bands * self.block

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` through the block-banded matvec kernel."""
        return ops.bbmv(self.A_bands, x, bands=self.bands, block=self.block)

    def packed_band_tiles(self) -> torch.Tensor:
        """The tiles with border tiles zeroed, as the fused sweep reads
        them (memoized)."""
        if self._packed is None:
            self._packed = pack_bands_local(self.A_bands, self.bands)
        return self._packed

    def window_tiles(self, blocks: slice) -> torch.Tensor:
        """The packed tiles of block rows ``blocks`` between ``bands`` zero
        block rows a side: what ``banded_window_matvec`` reads to compute
        those rows of A·v from their halo-padded window of v."""
        own = self.packed_band_tiles()[blocks]
        return torch.nn.functional.pad(own, (0, 0, 0, 0, 0, 0, self.bands,
                                             self.bands))

    def gs_sweep(self, b, x, picks, *, beta: float = 1.0) -> torch.Tensor:
        """Fused sequential block-GS sweep: one step per picked block row,
        on x padded with ``bands`` zero blocks a side; returns a new x."""
        halo = self.bands * self.block
        xw = torch.nn.functional.pad(x, (0, 0, halo, halo))
        xw = ops.banded_gs_sweep(self.packed_band_tiles(), b, xw, picks,
                                 block=self.block, bands=self.bands,
                                 beta=beta)
        return xw[halo:halo + self.n]

    def row_norms_sq(self) -> torch.Tensor:
        """Per-row ||A_i||² from the tiles, shaped (nb, block) — always
        f32 whatever the storage."""
        t = self.A_bands.float()
        return (t * t).sum(dim=(1, 3))

    def nnz_cost(self) -> int:
        return self.nb * self.width * self.block * self.block

    def to_dense(self) -> torch.Tensor:
        nb, bl = self.nb, self.block
        out = torch.zeros((nb, bl, nb, bl), dtype=self.A_bands.dtype,
                          device=self.device)
        valid = ref.band_valid(nb, self.bands, self.device)
        i, d = valid.nonzero(as_tuple=True)
        out.permute(0, 2, 1, 3)[i, i + d - self.bands] = self.A_bands[i, d]
        return out.reshape(self.n, self.n)


class EllOp:
    """Fixed-width ELLPACK operator: ``vals``/``cols`` of shape (n, width),
    per-row windows with global column ids, padding slots holding value 0
    and the row's own index.  ELL already is the padded-row form the sweep
    kernels read."""

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor):
        self.vals = vals
        self.cols = cols
        self._row_counts = None
        self._stored = None
        self._row_norms: torch.Tensor | None = None
        self._neighbors: dict[int, np.ndarray] = {}

    @classmethod
    def from_dense(cls, A: torch.Tensor, *, width: int | None = None,
                   storage_dtype=None) -> "EllOp":
        """The ``width`` largest-magnitude entries of each row of ``A``
        (``spd.ell_from_dense``).  ``width=None`` takes the largest nonzero
        count of any row, so the operator holds every entry; a smaller
        width drops each row's smallest entries.  ``storage_dtype`` rounds
        the values; column ids narrow to int16 alongside when every id
        fits."""
        if width is None:
            width = max(1, int((A != 0).sum(1).max()))
        vals, cols = ell_from_dense(A, width)
        dt = canonical_storage_dtype(storage_dtype)
        if dt is not None:
            vals = vals.to(dt)
            cols = cols.to(_index_dtype(dt, A.shape[1]))
        return cls(vals, cols)

    @property
    def shape(self) -> tuple[int, int]:
        n = self.vals.shape[0]
        return (n, n)

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def halo_width(self):
        """Gather columns are unstructured: no finite halo."""
        return None

    def slab_neighbors(self, num_workers: int) -> np.ndarray:
        """Row-slab neighbor graph (``slab_neighbor_matrix``) of the stored
        nonzeros, memoized per worker count."""
        if num_workers not in self._neighbors:
            n, w = self.vals.shape
            rows = torch.arange(n, device=self.device)[:, None].expand(n, w)
            self._neighbors[num_workers] = slab_neighbor_matrix(
                rows, self.cols, self.vals != 0, n, n, num_workers)
        return self._neighbors[num_workers]

    def row_counts(self) -> torch.Tensor:
        """Per-row count of stored entries, (n,) int32 on the device:
        min(count, width), the slots before each row's padding
        (``kernels/spmv_csr.py::row_extent``), computed once."""
        if self._row_counts is None:
            self._row_counts = row_extent(self.vals, self.cols)
        return self._row_counts

    def stop_counts(self, k: int) -> torch.Tensor | None:
        """``row_counts()`` where a matvec with k columns stops each row
        (``kernels/spmv_csr.py::worth_stopping``), else None; the count
        of stored entries is taken once."""
        if self._stored is None:
            self._stored = int(self.row_counts().sum())
        rows, width = self.vals.shape
        return (self.row_counts()
                if worth_stopping(rows, width, self._stored, k) else None)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` through the ELL matvec kernel, each row's chain
        stopped after its first padding slot where that pays (bitwise the
        same either way)."""
        return ops.spmv_ell(self.vals, self.cols, x,
                            counts=self.stop_counts(x.shape[1]))

    def row_norms_sq(self) -> torch.Tensor:
        """Per-row ||A_i||² — always f32, bitwise the reference's
        (``window_norms_sq``), computed once."""
        if self._row_norms is None:
            self._row_norms = window_norms_sq(self.vals)
        return self._row_norms

    def nnz_cost(self) -> int:
        n, w = self.vals.shape
        return n * w

    def padded_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.vals, self.cols

    def gs_sweep(self, b, x, picks, *, beta: float = 1.0,
                 write_base: int = 0) -> torch.Tensor:
        """Fused sequential coordinate-GS sweep over the stored windows;
        returns a new x."""
        return ops.sweep_rows_gs(self.vals, self.cols, b, x, picks, beta=beta,
                                 write_base=write_base)

    def rk_sweep(self, b, rn, x, picks, *, beta: float = 1.0) -> torch.Tensor:
        """Fused sequential Kaczmarz sweep over the stored windows; ``rn``
        is the caller's row-norm vector (the divisor).  Returns a new x."""
        return ops.sweep_rows_rk(self.vals, self.cols, b, rn, x, picks,
                                 beta=beta)

    def to_dense(self) -> torch.Tensor:
        n = self.vals.shape[0]
        rows = torch.arange(n, device=self.device)[:, None].expand_as(self.cols)
        out = torch.zeros((n, n), dtype=self.vals.dtype, device=self.device)
        return out.index_put_((rows, self.cols.long()), self.vals,
                              accumulate=True)


class CsrOp:
    """Compressed-sparse-row operator in the reference's panel-aligned
    layout.

    Nonzeros stay in row-major CSR order, but each *panel* of
    ``rows_per_panel`` consecutive rows is padded to a common nnz budget
    ``panel_width`` (a multiple of ``lane``):

    * ``data``/``indices``/``row_id`` — value, column and row of every slot
      (padding slots carry value 0, column 0, row 0);
    * ``row_start``/``row_nnz`` — row ``r`` occupies slots
      ``[row_start[r], row_start[r] + row_nnz[r])``, never straddling a
      panel.  ``row_cap`` slack slots follow the last panel.

    The kernels read the flat arrays (the segment-sum matvec, each row
    through ``row_start``/``row_nnz``: ``segsum_rows()``) and two derived
    views, memoized on first use: ``padded_rows()`` (the sweeps) and
    ``sliced_rows()`` (the sliced matvec).  All of these arrays equal the
    reference operator's exactly.
    """

    def __init__(self, data, indices, row_id, row_start, row_nnz, *,
                 shape, nnz, row_cap, rows_per_panel, panel_width):
        self.data = data
        self.indices = indices
        self.row_id = row_id
        self.row_start = row_start
        self.row_nnz = row_nnz
        self._shape = tuple(shape)
        self.nnz = nnz
        self.row_cap = row_cap
        self.rows_per_panel = rows_per_panel
        self.panel_width = panel_width
        self._padded: tuple[torch.Tensor, torch.Tensor] | None = None
        self._sliced: tuple[torch.Tensor, torch.Tensor] | None = None
        self._panel_nnz: torch.Tensor | None = None
        self._has_empty_panel: bool | None = None
        self._panel0_tail: bool | None = None
        self._row_norms: torch.Tensor | None = None
        self._neighbors: dict[int, np.ndarray] = {}

    @classmethod
    def from_dense(cls, A: torch.Tensor, *, rows_per_panel: int = 8,
                   lane: int = 128, storage_dtype=None) -> "CsrOp":
        """Exact CSR capture of every nonzero of dense ``A``, built with
        torch ops on A's device.  The host reads three scalars in one read
        (the count of nonzeros, the largest row count and the largest
        panel count), and ``torch.nonzero`` waits once more for its size.

        ``storage_dtype`` rounds the captured values (the pattern is taken
        from the input first, so the stored sparsity does not depend on
        it); column indices narrow to int16 alongside when every id fits.
        """
        m, n = A.shape
        nz = A != 0
        counts = nz.sum(1)
        scalars = _layout_scalars(counts, rows_per_panel)
        rows, cols = nz.nonzero(as_tuple=True)          # row-major order
        del nz
        cap = max(scalars[1], 1)
        slot = (torch.arange(rows.numel(), device=A.device)
                - (torch.cumsum(counts, 0) - counts)[rows])
        row_vals = torch.zeros((max(m, 1), cap), dtype=A.dtype,
                               device=A.device)
        row_cols = torch.zeros((max(m, 1), cap), dtype=torch.int32,
                               device=A.device)
        row_vals[rows, slot] = A[rows, cols]
        row_cols[rows, slot] = cols.to(torch.int32)
        dt = canonical_storage_dtype(storage_dtype)
        if dt is not None:
            row_vals = row_vals.to(dt)
        return cls._assemble(row_vals, row_cols, counts, shape=(m, n),
                             rows_per_panel=rows_per_panel, lane=lane,
                             scalars=scalars)

    @classmethod
    def _assemble(cls, row_vals, row_cols, counts, *, shape,
                  rows_per_panel: int = 8, lane: int = 128,
                  scalars=None) -> "CsrOp":
        """Pack per-row windows into the panel-aligned flat layout, with
        torch ops on the windows' device.

        ``row_vals``/``row_cols`` are (m, >= max nnz/row) tensors whose
        first ``counts[r]`` slots hold row ``r``'s values and global column
        ids; slots past the count are ignored.  ``counts`` may be a tensor,
        a numpy array or a list.  ``scalars`` are ``_layout_scalars`` of
        the counts where the caller has read them already; else the host
        reads them here, in one read.  Offsets are int64 up to the final
        int32 casts.
        """
        m, n = shape
        dev = row_vals.device
        counts = torch.as_tensor(counts, dtype=torch.int64,
                                 device=dev).reshape(-1)
        R = rows_per_panel
        num_panels = -(-m // R)
        per_panel = _per_panel(counts, R)
        nnz, cap, widest = scalars or _layout_scalars(counts, R)
        row_cap = max(cap, 1)
        W = -(-max(widest, 1) // lane) * lane
        total = num_panels * W + row_cap        # row-window slack at the end
        # Row r starts at its panel's base plus the counts of the rows
        # before it in the panel.
        within = torch.cumsum(per_panel, 1) - per_panel
        starts = (torch.arange(num_panels, device=dev)[:, None] * W
                  + within).reshape(-1)[:m]
        row_start = torch.zeros((max(m, 1),), dtype=torch.int32, device=dev)
        row_start[:m] = starts.to(torch.int32)
        rows = torch.repeat_interleave(torch.arange(m, device=dev), counts,
                                       output_size=nnz)
        j = (torch.arange(nnz, device=dev)
             - torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                       counts, output_size=nnz))
        slot = starts[rows] + j
        data = torch.zeros((total,), dtype=row_vals.dtype, device=dev)
        cols = torch.zeros((total,), dtype=_index_dtype(row_vals.dtype, n),
                           device=dev)
        row_id = torch.zeros((total,), dtype=torch.int32, device=dev)
        data[slot] = row_vals[rows, j]
        cols[slot] = row_cols[rows, j].to(cols.dtype)
        row_id[slot] = rows.to(torch.int32)
        return cls(data, cols, row_id, row_start, counts.to(torch.int32),
                   shape=(m, n), nnz=nnz, row_cap=row_cap,
                   rows_per_panel=R, panel_width=W)

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def halo_width(self):
        """Gather columns are unstructured: no finite halo."""
        return None

    def slab_neighbors(self, num_workers: int) -> np.ndarray:
        """Row-slab neighbor graph (``slab_neighbor_matrix``) of the stored
        nonzeros (padding slots hold 0 and are not read as neighbors),
        memoized per worker count: the graph is a property of the
        pattern, and the distributed engine asks for it every solve."""
        if num_workers not in self._neighbors:
            m, n = self._shape
            self._neighbors[num_workers] = slab_neighbor_matrix(
                self.row_id, self.indices, self.data != 0, m, n,
                num_workers)
        return self._neighbors[num_workers]

    def row_reach(self) -> torch.Tensor:
        """Per-row reach ``max_j |col_ij - i|`` over the stored nonzeros,
        (m,) int32 on the device: the per-row refinement of the scalar
        ``halo_width`` (square systems; 0 for empty rows)."""
        d = (self.indices.long() - self.row_id.long()).abs()
        d = torch.where(self.data != 0, d, 0)
        out = torch.zeros((self._shape[0],), dtype=torch.int64,
                          device=self.device)
        out.scatter_reduce_(0, self.row_id.long(), d, "amax")
        return out.to(torch.int32)

    def nnz_cost(self) -> int:
        return self.nnz

    def padded_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(m, row_cap) per-row value/column windows with global column
        ids, padding slots (value 0, column 0) past each row's count — what
        the sweeps read."""
        if self._padded is None:
            slots = torch.arange(self.row_cap, device=self.device)
            idx = self.row_start[:, None].long() + slots[None, :]
            idx = idx.clamp(max=self.data.shape[0] - 1)
            pad = slots[None, :] >= self.row_nnz[:, None]
            self._padded = (self.data[idx].masked_fill(pad, 0),
                            self.indices[idx].masked_fill(pad, 0))
        return self._padded

    def sliced_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Sliced-ELL view: the ``padded_rows()`` windows padded to a width
        that is a multiple of 8 and to whole panels
        (``num_panels * rows_per_panel`` rows) — what the matvec reads."""
        if self._sliced is None:
            m = self._shape[0]
            mp = -(-max(m, 1) // self.rows_per_panel) * self.rows_per_panel
            width = -(-self.row_cap // 8) * 8
            out = []
            for a in self.padded_rows():
                full = torch.zeros((mp, width), dtype=a.dtype,
                                   device=a.device)
                full[:a.shape[0], :a.shape[1]] = a
                out.append(full)
            self._sliced = (out[0], out[1])
        return self._sliced

    def panel_nnz(self) -> torch.Tensor:
        """Per-panel stored-nonzero counts, (num_panels,) int32 on the
        device — the predicate of the empty-panel-skipping matvec.  Its two
        flags (an empty panel, panel 0's tail) are memoised from one small
        host read."""
        if self._panel_nnz is None:
            per_panel = _per_panel(self.row_nnz, self.rows_per_panel).sum(1)
            if per_panel.numel():
                empty, tail = torch.stack(
                    [(per_panel == 0).any(),
                     per_panel[0] < self.panel_width]).tolist()
            else:
                empty, tail = False, False
            self._has_empty_panel = bool(empty)
            self._panel0_tail = bool(tail)
            self._panel_nnz = per_panel.to(torch.int32)
        return self._panel_nnz

    def matvec(self, x: torch.Tensor, *, variant: str | None = None,
               skip_empty: bool | None = None) -> torch.Tensor:
        """``A @ x`` — the tunable CSR matvec seam.

        Four kernels compute it (``tune.table.MATVEC_VARIANTS``): the
        sliced-ELL kernel (``"sliced"``), its empty-panel-predicated twin
        (``"sliced_prefetch"``), and the segment sum over the flat layout
        (``"segsum"``) with its predicated twin (``"segsum_prefetch"``).
        Selection order, the reference's:

        1. an explicit ``variant`` runs that kernel;
        2. an explicit ``skip_empty`` runs the sliced kernel, predicated
           iff True;
        3. the active tuning table's ``matvec`` entry for this operator's
           shape bucket and storage dtype, when there is one;
        4. the predicated sliced kernel iff the stored pattern has an empty
           panel, the plain sliced kernel otherwise.
        """
        if variant is None:
            if skip_empty is not None:
                variant = "sliced_prefetch" if skip_empty else "sliced"
            else:
                variant = tune_runtime.matvec_variant(self)
                if variant is None:
                    self.panel_nnz()        # memoizes _has_empty_panel
                    variant = ("sliced_prefetch" if self._has_empty_panel
                               else "sliced")
        if variant in ("segsum", "segsum_prefetch"):
            return self.matvec_segsum(x,
                                      skip_empty=variant == "segsum_prefetch")
        if variant not in ("sliced", "sliced_prefetch"):
            raise ValueError(f"unknown matvec variant: {variant!r} "
                             f"(expected one of {MATVEC_VARIANTS})")
        vals, cols = self.sliced_rows()
        m, R = self._shape[0], self.rows_per_panel
        if variant == "sliced_prefetch":
            return ops.spmv_csr_sliced_prefetch(vals, cols, self.panel_nnz(),
                                                x, m=m, rows_per_panel=R,
                                                counts=self.stop_counts(
                                                    x.shape[1]))
        return ops.spmv_csr_sliced(vals, cols, x, m=m, rows_per_panel=R,
                                   counts=self.stop_counts(x.shape[1]))

    def row_counts(self) -> torch.Tensor:
        """Per-row stored-nonzero counts, (m,) int32 on the device: the
        slots before each row's padding in ``padded_rows()`` and
        ``sliced_rows()``."""
        return self.row_nnz

    def stop_counts(self, k: int) -> torch.Tensor | None:
        """``row_counts()`` where a matvec with k columns over the sliced
        view stops each row (``kernels/spmv_csr.py::worth_stopping``; the
        kernel computes rows [0, m) only), else None."""
        width = -(-self.row_cap // 8) * 8
        return (self.row_nnz if worth_stopping(self._shape[0], width,
                                               self.nnz, k) else None)

    def segsum_rows(self) -> dict:
        """What the segment-sum kernels read each row's slots from, as
        keywords of ``ops.spmv_csr``: ``row_start`` and ``row_nnz`` (row r's
        slots are ``[row_start[r], row_start[r] + row_nnz[r])``, packed from
        its panel's first slot) and ``panel0_tail``, whether panel 0 holds
        padding after its last stored slot (``panel_nnz[0] <
        panel_width``), which the row-id sum adds to row 0.  The flag is
        taken once, with ``panel_nnz()``."""
        self.panel_nnz()
        return dict(row_start=self.row_start, row_nnz=self.row_nnz,
                    panel0_tail=self._panel0_tail)

    def matvec_segsum(self, x: torch.Tensor, *,
                      skip_empty: bool = False) -> torch.Tensor:
        """``A @ x`` by the segment-sum kernels over the stored flat layout
        (the reference's legacy contrast case): each output row chains its
        own slots, found through ``segsum_rows()``, bitwise the segment sum
        over ``row_id``; ``skip_empty`` runs the predicated twin."""
        kw = dict(m=self._shape[0], rows_per_panel=self.rows_per_panel,
                  panel_width=self.panel_width, **self.segsum_rows())
        if skip_empty:
            return ops.spmv_csr_prefetch(self.data, self.indices, self.row_id,
                                         self.panel_nnz(), x, **kw)
        return ops.spmv_csr(self.data, self.indices, self.row_id, x, **kw)

    def matvec_ref(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` by a segment sum over the flat layout (the reference's
        ``matvec_ref``); kept for the tests."""
        return ref.spmv_csr_ref(self.data, self.indices, self.row_id, x,
                                m=self._shape[0])

    def row_norms_sq(self) -> torch.Tensor:
        """Per-row ||A_i||² — always f32, each row's squares added left to
        right over its window (``padded_rows()``, ``window_norms_sq``):
        bitwise the reference's segment sum, and the same from run to run
        on the card too (a segment sum by ``index_add_`` adds with atomics
        there, in no fixed order).  Computed once."""
        if self._row_norms is None:
            self._row_norms = window_norms_sq(
                self.padded_rows()[0][:self._shape[0]])
        return self._row_norms

    def gs_sweep(self, b, x, picks, *, beta: float = 1.0,
                 write_base: int = 0) -> torch.Tensor:
        """Fused sequential coordinate-GS sweep over ``padded_rows()``;
        returns a new x."""
        vals, cols = self.padded_rows()
        return ops.sweep_rows_gs(vals, cols, b, x, picks, beta=beta,
                                 write_base=write_base)

    def rk_sweep(self, b, rn, x, picks, *, beta: float = 1.0) -> torch.Tensor:
        """Fused sequential Kaczmarz sweep over ``padded_rows()``; ``rn`` is
        the caller's row-norm vector (the divisor).  Returns a new x."""
        vals, cols = self.padded_rows()
        return ops.sweep_rows_rk(vals, cols, b, rn, x, picks, beta=beta)

    def block_gs_sweep(self, b, x, blocks, *, block: int,
                       beta: float = 1.0) -> torch.Tensor:
        """Sequential randomized block-GS steps over ``padded_rows()``, one
        per panel id ``bi``: ``x[B] += beta * (b[B] - A[B, :] @ x)`` on the
        rows ``B = [bi * block, (bi + 1) * block)``, every row's residual
        taken before the panel is written; one launch of the block-GS sweep
        kernel on the card, its plain version on the CPU.  Returns a new
        x."""
        vals, cols = self.padded_rows()
        return ops.sweep_rows_block_gs(vals, cols, b, x, blocks, block=block,
                                       beta=beta)

    def _panel_rows(self, bi, block: int) -> torch.Tensor:
        bi = int(bi)
        if bi < 0 or block < 1 or (bi + 1) * block > self._shape[0]:
            raise IndexError(f"panel {bi} of {block} rows lies outside the "
                             f"operator's {self._shape[0]} rows")
        return bi * block + torch.arange(block, device=self.device)

    def row_panel(self, bi, block: int) -> torch.Tensor:
        """Dense (block, n) rows of aligned panel ``bi`` in the storage
        dtype (the reference's block-GS read; a test aid here, the sweep
        reads the row windows)."""
        rows = self._panel_rows(bi, block)
        vals, cols = self.padded_rows()
        out = torch.zeros((block, self._shape[1]), dtype=self.data.dtype,
                          device=self.device)
        panel = torch.arange(block, device=self.device)[:, None]
        # added, not set: padding slots (+0 at column 0) may share a row's
        # real column 0, and adding +0 keeps its value exact
        return out.index_put_((panel.expand(-1, vals.shape[1]),
                               cols[rows].long()), vals[rows],
                              accumulate=True)

    def residual_panel(self, b, x, bi, block: int) -> torch.Tensor:
        """``(b - A x)`` on the rows of aligned panel ``bi``, (block, k) f32,
        in Θ(block · row_cap): each row's window contracted in slot order
        (``kernels/ref.py::window_dot``)."""
        rows = self._panel_rows(bi, block)
        vals, cols = self.padded_rows()
        return b[rows] - ref.window_dot(vals[rows], cols[rows], x)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self._shape, dtype=self.data.dtype,
                          device=self.device)
        return out.index_put_((self.row_id.long(), self.indices.long()),
                              self.data, accumulate=True)


def as_operator(A: torch.Tensor, format: str = "dense", *, block: int = 128,
                bands: int = 2, width: int | None = None,
                rows_per_panel: int = 8,
                storage_dtype=None):
    """Build an operator of the requested ``format`` from a dense matrix.

    ``block``/``bands`` shape the banded format, ``width`` the ELL format
    (``None``: the largest nonzero count of any row, exact; a smaller
    width keeps each row's ``width`` largest entries), ``rows_per_panel``
    the CSR panels.
    ``storage_dtype`` ("float32"/"bfloat16"/None) selects the coefficient
    storage precision; ``None`` keeps the input dtype.  The iterate, row
    norms and every kernel accumulator stay f32 regardless.
    """
    dt = canonical_storage_dtype(storage_dtype)
    if format == "dense":
        return DenseOp(A if dt is None else A.to(dt))
    if format == "banded":
        return BlockBandedOp.from_dense(A, block=block, bands=bands,
                                        storage_dtype=storage_dtype)
    if format == "ell":
        return EllOp.from_dense(A, width=width, storage_dtype=storage_dtype)
    if format == "csr":
        return CsrOp.from_dense(A, rows_per_panel=rows_per_panel,
                                storage_dtype=storage_dtype)
    raise ValueError(f"unknown operator format: {format!r}")
