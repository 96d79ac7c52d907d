"""Plain PyTorch versions of the fused banded sweeps (``kernels/banded_gs.py``):
the CPU path of ``ops.banded_gs_sweep`` / ``ops.banded_rk_sweep`` and the
versions ``chip_smoke.py`` holds the CUDA kernels against."""
from __future__ import annotations

from repro_torch.kernels.ref import tile_dot


def _panel_residual(A_bands, b, xw, bi: int, *, block: int, bands: int):
    """``b[bi] - sum_d A_bands[bi, d] @ xw[bi + d]``, band by band."""
    g = b[bi * block:(bi + 1) * block].float()
    for d in range(2 * bands + 1):
        g = g - tile_dot(A_bands[bi, d],
                         xw[(bi + d) * block:(bi + d + 1) * block])
    return g


def banded_gs_sweep_ref(A_bands, b, xw, picks, *, block: int, bands: int,
                        beta: float = 1.0):
    """``len(picks)`` sequential banded block-GS steps on the halo-padded
    window ``xw``; returns a new window.  Per pick ``bi``:
    ``g = b[bi] - sum_d A_bands[bi, d] @ xw[bi + d]`` (band by band), then
    ``xw[bi + bands] += beta * g``."""
    xw = xw.clone()
    for bi in picks.tolist():
        g = _panel_residual(A_bands, b, xw, bi, block=block, bands=bands)
        r0 = (bi + bands) * block
        xw[r0:r0 + block] = xw[r0:r0 + block] + beta * g
    return xw


def banded_rk_sweep_ref(A_bands, b, rn, xw, dw, picks, gates, *, block: int,
                        bands: int, beta: float = 1.0):
    """``len(picks)`` sequential masked banded Kaczmarz panel steps on the
    halo-padded window ``xw`` (read and written) and the delta window
    ``dw`` (written only); returns new ``(xw, dw)``.  Per pick ``bi`` with
    gate ``gate``: ``g = b[bi] - sum_d A_bands[bi, d] @ xw[bi + d]``, then
    ``gn = ((beta if gate > 0 else 0) * g) / rn[bi]`` and, for every band
    ``d``, ``A_bands[bi, d]^T @ gn`` (summed over the tile's rows in order)
    added to block row ``bi + d`` of both windows.  A gate of 0 adds exact
    zeros."""
    xw, dw = xw.clone(), dw.clone()
    for bi, gate in zip(picks.tolist(), gates.tolist()):
        g = _panel_residual(A_bands, b, xw, bi, block=block, bands=bands)
        gn = ((beta if gate > 0 else 0.0) * g) / rn[bi][:, None]
        for d in range(2 * bands + 1):
            contrib = tile_dot(A_bands[bi, d].transpose(0, 1), gn)
            rows = slice((bi + d) * block, (bi + d + 1) * block)
            xw[rows] = xw[rows] + contrib
            dw[rows] = dw[rows] + contrib
    return xw, dw
