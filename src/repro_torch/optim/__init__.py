"""repro_torch.optim — the distributed engine's wire codec
(``compression``, port of ``repro/optim/compression.py``)."""

from repro_torch.optim import compression

__all__ = ["compression"]
