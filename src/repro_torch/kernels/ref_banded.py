"""Plain PyTorch version of the fused banded block-GS sweep
(``kernels/banded_gs.py``): the CPU path of ``ops.banded_gs_sweep`` and the
version ``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

from repro_torch.kernels.ref import tile_dot


def banded_gs_sweep_ref(A_bands, b, xw, picks, *, block: int, bands: int,
                        beta: float = 1.0):
    """``len(picks)`` sequential banded block-GS steps on the halo-padded
    window ``xw``; returns a new window.  Per pick ``bi``:
    ``g = b[bi] - sum_d A_bands[bi, d] @ xw[bi + d]`` (band by band), then
    ``xw[bi + bands] += beta * g``."""
    xw = xw.clone()
    for bi in picks.tolist():
        g = b[bi * block:(bi + 1) * block].float()
        for d in range(2 * bands + 1):
            g = g - tile_dot(A_bands[bi, d],
                             xw[(bi + d) * block:(bi + d + 1) * block])
        r0 = (bi + bands) * block
        xw[r0:r0 + block] = xw[r0:r0 + block] + beta * g
    return xw
