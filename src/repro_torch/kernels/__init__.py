"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions and the dispatch seam.

sweep_csr - fused sequential coordinate-GS / Kaczmarz sweeps over padded rows
            (CSR and ELL), and the two-carry Kaczmarz sweep of the
            distributed engine
spmv_csr  - CSR matvecs: over the sliced-ELL view and by a segment sum over
            the flat panel-aligned layout, each plain and
            empty-panel-predicated
spmv_ell  - ELL matvec (also over a slab of padded rows)
bbmv      - block-banded matvec (and the band-tile layout helpers)
banded_gs - fused banded block-GS sweep over a halo-padded window, and the
            masked two-carry banded Kaczmarz sweep of the distributed engine
block_gs  - dense randomized block-GS sweep (one cooperative launch)
colsum    - column sums of the records, in an order that does not depend on
            the column count (a kernel of the port's own)

Use ``repro_torch.kernels.ops`` for the checked wrappers (CPU tensors run
the plain versions of ``repro_torch.kernels.ref``, CUDA tensors the
kernels).
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
