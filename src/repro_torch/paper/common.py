"""The drivers' output: one CSV-ish record a line (the reference's
``benchmarks/common.emit``)."""
from __future__ import annotations


def emit(name: str, **fields) -> None:
    """Print ``name,key=value,...`` for ``fields`` in order."""
    kv = ",".join(f"{k}={v}" for k, v in fields.items())
    print(f"{name},{kv}", flush=True)
