"""The dispatch seam between the operators and the kernels.

Every wrapper checks its arguments (device, dtype, shape, contiguity and
index bounds) and then dispatches on the device the tensors lie on: a CPU
tensor goes to the plain PyTorch version in ``kernels/ref.py``, a CUDA
tensor to the hand-written kernel.  Pick ids are data on the device: on
the card a check kernel launched before each sweep tests every id with a
device-side assert, as PyTorch's own indexing kernels do, so a launch
never waits for the host to read the picks back.  There is no fallback:
a CUDA tensor the kernel cannot take raises, and a kernel that fails to
build or launch raises.

``launch_counts()`` reports how often each kernel was launched since the
last ``reset_launch_counts()``; only the launchers (``sweep_csr.py``,
``spmv_csr.py``, ``spmv_ell.py``, ``bbmv.py``, ``banded_gs.py``,
``block_gs.py``, ``colsum.py``) increment them, where they launch.  The
counters are per process: a distributed run counts each rank's launches
in that rank's process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (_build, banded_gs, block_gs, ref, ref_banded,
                                 sweep_csr)
from repro_torch.kernels import colsum as _colsum
from repro_torch.kernels import spmv_csr as _spmv_csr
from repro_torch.kernels import bbmv as _bbmv
from repro_torch.kernels import spmv_ell as _spmv_ell

KERNELS = ("sweep_rows_gs", "sweep_rows_rk", "spmv_csr_sliced",
           "spmv_csr_sliced_prefetch", "spmv_ell", "bbmv", "banded_gs_sweep",
           "sweep_rows_rk_delta", "banded_rk_sweep", "block_gs_sweep",
           "spmv_csr", "spmv_csr_prefetch", "colsum", "sweep_rows_block_gs")
_COUNTERS = (sweep_csr.LAUNCHES, _spmv_csr.LAUNCHES, _spmv_ell.LAUNCHES,
             _bbmv.LAUNCHES, banded_gs.LAUNCHES, block_gs.LAUNCHES,
             _colsum.LAUNCHES)

# Largest block the band-tile and dense block-GS CUDA kernels take
# (csrc/banded_gs.cu: a lane of the banded Kaczmarz sweep's A^T gn holds
# at most two 4-column chunks of a tile row; csrc/bbmv.cu: at most four row
# warps and two staged chunks of all rows; csrc/block_gs.cu splits any
# block into 32-row units and is held to the same limit).
MAX_BLOCK = 256


def launch_counts() -> dict[str, int]:
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def _on_cuda(name: str, *tensors) -> bool:
    """Check that all tensors share one device and are contiguous; True
    for CUDA, False for the CPU, raise for anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every argument must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type == "cuda"


def _check_windows(name, vals, cols):
    if vals.ndim != 2 or vals.shape != cols.shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} must be equal 2-D shapes")
    if (vals.dtype, cols.dtype) not in _build.SUFFIX:
        raise TypeError(f"{name}: no kernel for values {vals.dtype} with "
                        f"indices {cols.dtype}")


def _check_f32(name, **tensors):
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")


def _picks(name, picks, hi: int, x):
    """int32 pick stream on x's device; every id must lie in [0, hi).  The
    range is checked here for CPU tensors and by the kernel on the card."""
    if picks.ndim != 1 or picks.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: picks must be a 1-D integer tensor")
    if picks.device != x.device:
        raise ValueError(f"{name}: picks on {picks.device}, x on {x.device}")
    if picks.numel() and picks.device.type == "cpu":
        lo, top = (int(v) for v in torch.aminmax(picks))
        if lo < 0 or top >= hi:
            raise IndexError(f"{name}: pick ids span [{lo}, {top}], "
                             f"allowed [0, {hi})")
    return picks.to(torch.int32).contiguous()


def sweep_rows_gs(vals, cols, b, x, picks, *, beta=1.0, write_base=0):
    """Fused coordinate-GS sweep over padded rows; returns a new x.

    vals/cols: (m, width) row windows (global column ids); b: (m, k) f32;
    x: (n, k) f32; picks: (steps,) row ids.  Pick ``r`` updates row
    ``write_base + r`` of x, so ``write_base + r`` must lie in [0, n).
    """
    name = "sweep_rows_gs"
    cuda = _on_cuda(name, vals, cols, b, x)
    _check_windows(name, vals, cols)
    _check_f32(name, b=b, x=x)
    m, n = vals.shape[0], x.shape[0]
    if b.shape != (m, x.shape[1]) or x.ndim != 2:
        raise ValueError(f"{name}: b {tuple(b.shape)} / x {tuple(x.shape)} "
                         f"do not fit {m} rows")
    write_base = int(write_base)
    if write_base < 0:
        raise IndexError(f"{name}: write_base {write_base} < 0")
    limit = min(m, n - write_base)
    picks = _picks(name, picks, limit, x)
    if cuda:
        return sweep_csr.sweep_rows_gs(vals, cols, b, x, picks, beta=beta,
                                       write_base=write_base, limit=limit)
    return ref.sweep_rows_gs_ref(vals, cols, b, x, picks, beta=beta,
                                 write_base=write_base)


def sweep_rows_block_gs(vals, cols, b, x, blocks, *, block: int, beta=1.0):
    """Fused block-GS sweep over padded rows; returns a new x.

    vals/cols: (n, width) row windows of a square operator (global column
    ids); b, x: (n, k) f32; blocks: (steps,) panel ids in [0, n // block).
    Pick ``bi`` updates rows ``B = [bi * block, (bi + 1) * block)``: every
    row's ``gamma = b[r] - <A_r, x>`` is taken before any of them is
    written, then ``x[B] += beta * gamma``.  At ``block = 1`` it is
    bitwise ``sweep_rows_gs``.
    """
    name = "sweep_rows_block_gs"
    cuda = _on_cuda(name, vals, cols, b, x)
    _check_windows(name, vals, cols)
    _check_f32(name, b=b, x=x)
    n = x.shape[0]
    if x.ndim != 2 or b.shape != x.shape or vals.shape[0] != n:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} / b "
                         f"{tuple(b.shape)} / x {tuple(x.shape)} is not "
                         "(n, width) / (n, k) / (n, k)")
    if not 1 <= block <= n:
        raise ValueError(f"{name}: block {block} must lie in [1, {n}]")
    blocks = _picks(name, blocks, n // block, x)
    if cuda:
        return sweep_csr.sweep_rows_block_gs(vals, cols, b, x, blocks,
                                             block=block, beta=beta,
                                             limit=n // block)
    return ref.sweep_rows_block_gs_ref(vals, cols, b, x, blocks, block=block,
                                       beta=beta)


def sweep_rows_rk(vals, cols, b, rn, x, picks, *, beta=1.0):
    """Fused Kaczmarz sweep over padded rows; returns a new x.

    vals/cols: (m, width) row windows; b: (m, k) f32; rn: (m,) f32 squared
    row norms (the caller's divisor); x: (n, k) f32; picks: (steps,).
    """
    name = "sweep_rows_rk"
    cuda = _on_cuda(name, vals, cols, b, rn, x)
    _check_windows(name, vals, cols)
    _check_f32(name, b=b, rn=rn, x=x)
    m = vals.shape[0]
    if b.shape != (m, x.shape[1]) or rn.shape != (m,) or x.ndim != 2:
        raise ValueError(f"{name}: b {tuple(b.shape)} / rn {tuple(rn.shape)} "
                         f"/ x {tuple(x.shape)} do not fit {m} rows")
    picks = _picks(name, picks, m, x)
    if cuda:
        return sweep_csr.sweep_rows_rk(vals, cols, b, rn, x, picks, beta=beta,
                                       limit=m)
    return ref.sweep_rows_rk_ref(vals, cols, b, rn, x, picks, beta=beta)


def sweep_rows_rk_delta(vals, cols, b, rn, x, d, picks, *, beta=1.0):
    """Fused two-carry Kaczmarz sweep over padded rows, the distributed
    local phase: each step reads and updates the replica ``x`` and adds
    the same contribution to the round delta ``d``.  Returns new
    ``(x, d)``.

    vals/cols: (m, width) row windows of a slab (global column ids);
    b: (m, k) f32; rn: (m,) f32 squared row norms with zero rows guarded
    by the caller; x, d: (n, k) f32; picks: (steps,) slab row ids.
    """
    name = "sweep_rows_rk_delta"
    cuda = _on_cuda(name, vals, cols, b, rn, x, d)
    _check_windows(name, vals, cols)
    _check_f32(name, b=b, rn=rn, x=x, d=d)
    m = vals.shape[0]
    if (b.shape != (m, x.shape[1]) or rn.shape != (m,) or x.ndim != 2
            or d.shape != x.shape):
        raise ValueError(f"{name}: b {tuple(b.shape)} / rn {tuple(rn.shape)} "
                         f"/ x {tuple(x.shape)} / d {tuple(d.shape)} do not "
                         f"fit {m} rows")
    picks = _picks(name, picks, m, x)
    if cuda:
        return sweep_csr.sweep_rows_rk_delta(vals, cols, b, rn, x, d, picks,
                                             beta=beta, limit=m)
    return ref.sweep_rows_rk_delta_ref(vals, cols, b, rn, x, d, picks,
                                       beta=beta)


def _check_counts(name, counts, rows: int, x, k: int):
    """The per-row counts of a row-window matvec: None, or int32 (rows,)
    on x's device.  The kernel that takes them indexes outputs in 32
    bits."""
    if counts is None:
        return
    if rows * k >= 2 ** 32:
        raise ValueError(f"{name}: {rows} x {k} outputs, the kernel with "
                         "counts takes fewer than 2^32")
    if (counts.dtype != torch.int32 or counts.shape != (rows,)
            or counts.device != x.device or not counts.is_contiguous()):
        raise ValueError(f"{name}: counts must be contiguous int32 of shape "
                         f"({rows},) on {x.device}, got {counts.dtype} "
                         f"{tuple(counts.shape)} on {counts.device}")


def _check_spmv(name, vals, cols, x, m, rows_per_panel, counts):
    _check_windows(name, vals, cols)
    _check_f32(name, x=x)
    num_panels = -(-m // rows_per_panel)
    if vals.shape[0] != num_panels * rows_per_panel or x.ndim != 2:
        raise ValueError(f"{name}: vals has {vals.shape[0]} rows, expected "
                         f"{num_panels} panels of {rows_per_panel}")
    _check_counts(name, counts, m, x, x.shape[1])
    return num_panels


def spmv_csr_sliced(vals, cols, x, *, m, rows_per_panel, counts=None):
    """``y = A @ x`` (m, k) f32 from the sliced-ELL view
    (``CsrOp.sliced_rows()``).

    ``counts`` (int32 (m,), ``CsrOp.row_nnz``) lets the kernel stop each
    row's chain after its first padding slot; every slot at or past
    ``counts[r]`` must hold the value +0 and the column of the row's last
    slot (``kernels/spmv_csr.py::row_extent``).  The result is then
    bitwise the same as without them, for any x.  The plain version reads
    every slot."""
    name = "spmv_csr_sliced"
    cuda = _on_cuda(name, vals, cols, x)
    _check_spmv(name, vals, cols, x, m, rows_per_panel, counts)
    if cuda:
        return _spmv_csr.spmv_csr_sliced(vals, cols, x, m=m, counts=counts)
    return ref.spmv_csr_sliced_ref(vals, cols, x, m=m)


def spmv_csr_sliced_prefetch(vals, cols, panel_nnz, x, *, m, rows_per_panel,
                             counts=None):
    """``spmv_csr_sliced`` with the rows of empty panels (``panel_nnz ==
    0``) written as zeros without reading their windows; bitwise equal to
    it for finite x (an empty panel's padding slots carry a NaN or inf of
    x's row 0 into the plain twin's rows of that panel)."""
    name = "spmv_csr_sliced_prefetch"
    cuda = _on_cuda(name, vals, cols, panel_nnz, x)
    num_panels = _check_spmv(name, vals, cols, x, m, rows_per_panel, counts)
    if panel_nnz.shape != (num_panels,) or panel_nnz.dtype != torch.int32:
        raise ValueError(f"{name}: panel_nnz must be int32 of shape "
                         f"({num_panels},)")
    if cuda:
        return _spmv_csr.spmv_csr_sliced_prefetch(
            vals, cols, panel_nnz, x, m=m, rows_per_panel=rows_per_panel,
            counts=counts)
    return ref.spmv_csr_sliced_prefetch_ref(vals, cols, panel_nnz, x, m=m,
                                            rows_per_panel=rows_per_panel)


def _check_segsum(name, data, indices, row_id, x, m, rows_per_panel,
                  panel_width):
    if data.ndim != 1 or data.shape != indices.shape \
            or data.shape != row_id.shape:
        raise ValueError(f"{name}: data {tuple(data.shape)}, indices "
                         f"{tuple(indices.shape)} and row_id "
                         f"{tuple(row_id.shape)} must be equal 1-D shapes")
    if (data.dtype, indices.dtype) not in _build.SUFFIX:
        raise TypeError(f"{name}: no kernel for values {data.dtype} with "
                        f"indices {indices.dtype}")
    if row_id.dtype != torch.int32:
        raise TypeError(f"{name}: row_id must be int32, got {row_id.dtype}")
    _check_f32(name, x=x)
    if rows_per_panel < 1 or panel_width < 0 or x.ndim != 2:
        raise ValueError(f"{name}: rows_per_panel {rows_per_panel} / "
                         f"panel_width {panel_width} / x {tuple(x.shape)}")
    num_panels = -(-m // rows_per_panel)
    if data.shape[0] < num_panels * panel_width:
        raise ValueError(f"{name}: {data.shape[0]} slots, expected at least "
                         f"{num_panels} panels of {panel_width}")
    return num_panels


def _check_rows(name, row_start, row_nnz, panel0_tail, m: int, x):
    """The layout the segment-sum kernel reads each row's slots from:
    ``row_start``/``row_nnz`` int32 (m,) (``row_start`` may be (1,) when
    m == 0, as ``CsrOp`` keeps it) on x's device, and ``panel0_tail`` a
    bool."""
    for arg, t, shapes in (("row_start", row_start, {(m,), (max(m, 1),)}),
                           ("row_nnz", row_nnz, {(m,)})):
        if (t.dtype != torch.int32 or tuple(t.shape) not in shapes
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous int32 of "
                             f"shape ({m},) on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not isinstance(panel0_tail, bool):
        raise TypeError(f"{name}: panel0_tail must be a bool, got "
                        f"{type(panel0_tail).__name__}")


def spmv_csr(data, indices, row_id, x, *, m, rows_per_panel, panel_width,
             row_start, row_nnz, panel0_tail):
    """``y = A @ x`` (m, k) f32 by a segment sum over the flat
    panel-aligned CSR layout (``CsrOp.data``/``indices``/``row_id``): panel
    ``p`` owns slots ``[p * panel_width, (p + 1) * panel_width)``, and each
    output row adds its slots in slot order.  x: (n, k) f32.

    The kernel finds row r's slots as ``[row_start[r], row_start[r] +
    row_nnz[r])`` (the layout packs a panel's rows from its first slot)
    and adds panel 0's tail to row 0 once where ``panel0_tail`` (one term:
    its padding slots hold +0 at column 0, and adding such a term twice is
    adding it once), so it never reads ``row_id`` or a tail; the result is
    the row-id segment sum's, bitwise (``CsrOp.segsum_rows()`` gives the
    three).  The plain version reads ``row_id``, as the TPU kernel
    does."""
    name = "spmv_csr"
    cuda = _on_cuda(name, data, indices, row_id, x)
    _check_segsum(name, data, indices, row_id, x, m, rows_per_panel,
                  panel_width)
    _check_rows(name, row_start, row_nnz, panel0_tail, m, x)
    if cuda:
        return _spmv_csr.spmv_csr(data, indices, row_start, row_nnz, x, m=m,
                                  panel0_tail=panel0_tail)
    return ref.spmv_csr_segsum_ref(data, indices, row_id, x, m=m,
                                   rows_per_panel=rows_per_panel,
                                   panel_width=panel_width)


def spmv_csr_prefetch(data, indices, row_id, panel_nnz, x, *, m,
                      rows_per_panel, panel_width, row_start, row_nnz,
                      panel0_tail):
    """``spmv_csr`` with the rows of empty panels (``panel_nnz == 0``)
    written as zeros without reading their slots; bitwise equal to it for
    finite x (an empty panel 0's tail carries a NaN or inf of x's row 0
    into the plain sum's row 0)."""
    name = "spmv_csr_prefetch"
    cuda = _on_cuda(name, data, indices, row_id, panel_nnz, x)
    num_panels = _check_segsum(name, data, indices, row_id, x, m,
                               rows_per_panel, panel_width)
    if panel_nnz.shape != (num_panels,) or panel_nnz.dtype != torch.int32:
        raise ValueError(f"{name}: panel_nnz must be int32 of shape "
                         f"({num_panels},)")
    _check_rows(name, row_start, row_nnz, panel0_tail, m, x)
    if cuda:
        return _spmv_csr.spmv_csr_prefetch(
            data, indices, row_start, row_nnz, panel_nnz, x, m=m,
            rows_per_panel=rows_per_panel, panel0_tail=panel0_tail)
    return ref.spmv_csr_segsum_prefetch_ref(data, indices, row_id, panel_nnz,
                                            x, m=m,
                                            rows_per_panel=rows_per_panel,
                                            panel_width=panel_width)


def spmv_ell(vals, cols, x, *, n_cols: int | None = None, counts=None):
    """``y = A @ x`` (rows, k) f32 from row windows vals/cols (rows, width)
    with global column ids; x: (n_cols, k) f32.

    ``n_cols`` is the column count of the operator the windows come from
    (its column ids lie in [0, n_cols)): ``None`` for a square ELL
    operator (n_cols = rows), the operator's ``shape[1]`` for a slab of
    its padded rows (the distributed engine's residual).  ``counts``
    (int32 (rows,), ``row_counts()`` of the operator) lets the kernel stop
    each row's chain after its first padding slot, as in
    ``spmv_csr_sliced``; the result is bitwise the same."""
    name = "spmv_ell"
    cuda = _on_cuda(name, vals, cols, x)
    _check_windows(name, vals, cols)
    _check_f32(name, x=x)
    n_cols = vals.shape[0] if n_cols is None else n_cols
    if x.ndim != 2 or x.shape[0] != n_cols:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit "
                         f"{n_cols} columns")
    _check_counts(name, counts, vals.shape[0], x, x.shape[1])
    if cuda:
        return _spmv_ell.spmv_ell(vals, cols, x, counts=counts)
    return ref.spmv_ell_ref(vals, cols, x)


def _check_bands(name, A_bands, bands: int, block: int, cuda: bool) -> int:
    """Shape and type of band tiles (nb, 2*bands+1, block, block); returns
    nb."""
    if (A_bands.ndim != 4 or A_bands.shape[1] != 2 * bands + 1
            or tuple(A_bands.shape[2:]) != (block, block) or block < 1):
        raise ValueError(f"{name}: A_bands {tuple(A_bands.shape)} is not "
                         f"(nb, {2 * bands + 1}, {block}, {block})")
    if A_bands.dtype not in _build.VALUE_SUFFIX:
        raise TypeError(f"{name}: no kernel for tiles of {A_bands.dtype}")
    if cuda and block > MAX_BLOCK:
        raise ValueError(f"{name}: the CUDA kernel takes block <= "
                         f"{MAX_BLOCK}, got {block}")
    return A_bands.shape[0]


def bbmv(A_bands, x, *, bands: int, block: int):
    """``y = A @ x`` (nb*block, k) f32 for block-banded tiles A_bands
    (nb, 2*bands+1, block, block); x: (nb*block, k) f32.  Tiles whose block
    column falls outside the matrix are never read."""
    name = "bbmv"
    cuda = _on_cuda(name, A_bands, x)
    nb = _check_bands(name, A_bands, bands, block, cuda)
    _check_f32(name, x=x)
    if x.ndim != 2 or x.shape[0] != nb * block:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit {nb} "
                         f"blocks of {block}")
    if cuda:
        return _bbmv.bbmv(A_bands, x, bands=bands, block=block)
    return ref.bbmv_ref(A_bands, x, bands=bands, block=block)


def banded_gs_sweep(A_bands, b, xw, picks, *, block: int, bands: int,
                    beta: float = 1.0):
    """Fused banded block-GS sweep; returns a new window.

    A_bands: (nb, 2*bands+1, block, block) with border tiles zero
    (``bbmv.pack_bands_local``); b: (nb*block, k) f32; xw: the halo-padded
    window ((nb + 2*bands)*block, k) f32; picks: (steps,) block-row ids in
    [0, nb).  On the card any band count runs whose ring of 2*bands+2
    tile stages fits in shared memory (``banded_gs.plan`` raises
    otherwise; 36 bands at block 128 in f32).
    """
    name = "banded_gs_sweep"
    cuda = _on_cuda(name, A_bands, b, xw)
    nb = _check_bands(name, A_bands, bands, block, cuda)
    _check_f32(name, b=b, xw=xw)
    k = b.shape[-1]
    if b.shape != (nb * block, k) or xw.shape != ((nb + 2 * bands) * block, k):
        raise ValueError(f"{name}: b {tuple(b.shape)} / xw {tuple(xw.shape)} "
                         f"do not fit {nb} blocks of {block} with {bands} "
                         "halo blocks a side")
    picks = _picks(name, picks, nb, xw)
    if cuda:
        return banded_gs.banded_gs_sweep(A_bands, b, xw, picks, block=block,
                                         bands=bands, beta=beta, limit=nb)
    return ref_banded.banded_gs_sweep_ref(A_bands, b, xw, picks, block=block,
                                          bands=bands, beta=beta)


def banded_rk_sweep(A_bands, b, rn, xw, dw, picks, gates, *, block: int,
                    bands: int, beta: float = 1.0):
    """Fused masked banded Kaczmarz sweep, the distributed local phase of
    banded RK; returns new ``(xw, dw)``.

    A_bands: (nb, 2*bands+1, block, block) with border tiles zero (a
    rank's rows of ``BlockBandedOp.packed_band_tiles()``); b: (nb*block, k)
    f32; rn: (nb, block) f32 squared row norms with zero rows guarded by
    the caller; xw, dw: halo-padded windows ((nb + 2*bands)*block, k) f32;
    picks: (steps,) block-row ids in [0, nb); gates: (steps,) integers, 0
    where the pick is not the caller's (same reads, exact-zero updates).
    """
    name = "banded_rk_sweep"
    cuda = _on_cuda(name, A_bands, b, rn, xw, dw)
    nb = _check_bands(name, A_bands, bands, block, cuda)
    _check_f32(name, b=b, rn=rn, xw=xw, dw=dw)
    k = b.shape[-1]
    if (b.shape != (nb * block, k) or rn.shape != (nb, block)
            or xw.shape != ((nb + 2 * bands) * block, k)
            or dw.shape != xw.shape):
        raise ValueError(f"{name}: b {tuple(b.shape)} / rn {tuple(rn.shape)} "
                         f"/ xw {tuple(xw.shape)} / dw {tuple(dw.shape)} do "
                         f"not fit {nb} blocks of {block} with {bands} halo "
                         "blocks a side")
    picks = _picks(name, picks, nb, xw)
    if (gates.shape != picks.shape or gates.device != xw.device
            or gates.dtype not in (torch.int32, torch.int64, torch.bool)):
        raise ValueError(f"{name}: gates must be integers of the picks' "
                         "shape on the windows' device")
    gates = gates.to(torch.int32).contiguous()
    if cuda:
        return banded_gs.banded_rk_sweep(A_bands, b, rn, xw, dw, picks, gates,
                                         block=block, bands=bands, beta=beta,
                                         limit=nb)
    return ref_banded.banded_rk_sweep_ref(A_bands, b, rn, xw, dw, picks, gates,
                                          block=block, bands=bands, beta=beta)


def block_gs_sweep(A, b, x, blocks, *, block: int, beta: float = 1.0):
    """Dense randomized block-GS sweep; returns a new x.

    A: (n, n) f32 or bf16; b, x: (n, k) f32; blocks: (steps,) block ids in
    [0, n // block).  Step ``bi`` updates rows
    ``[bi * block, (bi + 1) * block)``:
    ``x[B] += beta * (b[B] - A[B, :] @ x)``.
    """
    name = "block_gs_sweep"
    cuda = _on_cuda(name, A, b, x)
    if A.dtype not in _build.VALUE_SUFFIX:
        raise TypeError(f"{name}: no kernel for A of {A.dtype}")
    _check_f32(name, b=b, x=x)
    n = A.shape[0]
    if A.ndim != 2 or A.shape != (n, n) or x.ndim != 2 \
            or x.shape[0] != n or b.shape != x.shape:
        raise ValueError(f"{name}: A {tuple(A.shape)} / b {tuple(b.shape)} / "
                         f"x {tuple(x.shape)} is not (n, n) / (n, k) / (n, k)")
    if not 1 <= block <= n:
        raise ValueError(f"{name}: block {block} must lie in [1, {n}]")
    if cuda and block > MAX_BLOCK:
        raise ValueError(f"{name}: the CUDA kernel takes block <= "
                         f"{MAX_BLOCK}, got {block}")
    blocks = _picks(name, blocks, n // block, x)
    if cuda:
        return block_gs.block_gs_sweep(A, b, x, blocks, block=block,
                                       beta=beta, limit=n // block)
    return ref.block_gs_sweep_ref(A, b, x, blocks, block=block, beta=beta)


def colsum(t):
    """Column sums ``t.sum(0)`` of an (n, k) f32 tensor, (k,) f32.

    Each column is added in an order fixed by ``n`` alone, so a column's
    sum does not depend on how many columns ride along: the record sums
    of a zero-padded RHS column equal the solo column's bitwise.  On the
    card that is the colsum kernel (``torch.sum`` there picks its order
    by the output count); on the CPU each column is reduced on its own
    contiguous copy."""
    name = "colsum"
    cuda = _on_cuda(name, t)
    _check_f32(name, t=t)
    if t.ndim != 2:
        raise ValueError(f"{name}: t must be 2-D, got {tuple(t.shape)}")
    if cuda:
        return _colsum.colsum(t)
    return ref.colsum_ref(t)
