"""The persisted tuning table: measured dispatch choices, backend-keyed
(port of ``repro/tune/table.py``).

The engine chooses among interchangeable implementations at two seams:
the CSR matvec variant (the sliced-ELL kernel, its empty-panel-predicated
twin, and the segment-sum pair over the flat layout) and the CSR
``rows_per_panel`` layout.  The autotuner (``tune/autotune.py``) measures
the candidates on the card at hand and writes the winners here; the
dispatch seams look them up at solve time (``tune/runtime.py``).

Schema (``SCHEMA_VERSION``, the reference's, with the same key strings):

.. code-block:: json

    {
      "version": 1,
      "backend": "cuda",
      "device_kind": "NVIDIA H100 80GB HBM3",
      "torch_version": "2.x",
      "entries": {
        "matvec/CsrOp/-/n16384/f32":
            {"choice": "sliced", "wall_us": {"sliced": 61.0, "...": 0.0}}
      }
    }

Key axes (``TuneKey``): ``kernel`` ("matvec" = the CSR matvec variant
family, "panel" = the CSR ``rows_per_panel`` layout); ``format`` the
operator class name; ``action`` "-" (neither kernel has an action axis);
``bucket`` the row count rounded up to a power of two; ``storage_dtype``
"f32"/"bf16".  One file per backend, ``TUNE_torch_<backend>.json`` at the
root of the checkout: the reference's ``TUNE_cpu.json`` holds JAX
interpret-mode choices and is never read here.  The reference's "sweep"
key (fused sweep vs per-step scan) has no counterpart: the port has one
engine.
"""
from __future__ import annotations

import json
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

SCHEMA_VERSION = 1

#: Root of the checkout (src/repro_torch/tune/table.py -> three parents up).
REPO_ROOT = Path(__file__).resolve().parents[3]

#: the CSR matvec variant vocabulary ("matvec" kernel choices): the
#: sliced-ELL kernel, its empty-panel-predicated twin, and the segment-sum
#: pair over the flat panel-aligned layout
MATVEC_VARIANTS = ("sliced", "sliced_prefetch", "segsum", "segsum_prefetch")


class TuneKey(NamedTuple):
    """One tunable dispatch site: kernel x format x action x shape x dtype."""
    kernel: str         # "matvec" | "panel"
    format: str         # operator class name, e.g. "CsrOp"
    action: str         # "-" (no action axis)
    bucket: str         # shape bucket, e.g. "n1024"
    storage_dtype: str  # "f32" | "bf16"

    def render(self) -> str:
        return "/".join(self)

    @classmethod
    def parse(cls, s: str) -> "TuneKey":
        parts = s.split("/")
        if len(parts) != 5:
            raise ValueError(f"malformed tune key: {s!r}")
        return cls(*parts)


def shape_bucket(m: int) -> str:
    """Power-of-two row-count bucket: n=1000 and n=1024 share "n1024"."""
    m = max(int(m), 1)
    b = 1
    while b < m:
        b <<= 1
    return f"n{b}"


def storage_key(dtype) -> str:
    """'bf16' for bfloat16 coefficient storage, 'f32' otherwise."""
    return "bf16" if "bfloat16" in str(dtype) else "f32"


def backend_key() -> str:
    """The table file's backend axis: "cuda" with a CUDA device, else
    "cpu"."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, the
    stamp the probes print beside their times."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def default_path(backend: str | None = None) -> Path:
    return REPO_ROOT / f"TUNE_torch_{backend or backend_key()}.json"


@dataclass
class TuningTable:
    """In-memory form of ``TUNE_torch_<backend>.json``."""

    backend: str = ""
    device_kind: str = ""
    torch_version: str = ""
    version: int = SCHEMA_VERSION
    #: rendered ``TuneKey`` -> {"choice": str, "wall_us": {candidate: us}}
    entries: dict = field(default_factory=dict)

    @classmethod
    def fresh(cls, device) -> "TuningTable":
        """An empty table stamped with ``device``'s identity (a
        ``torch.device``)."""
        import torch
        cuda = device.type == "cuda"
        return cls(backend="cuda" if cuda else "cpu",
                   device_kind=(torch.cuda.get_device_name(device) if cuda
                                else "cpu"),
                   torch_version=torch.__version__)

    def record(self, key: TuneKey, choice: str, wall_us: dict) -> None:
        self.entries[key.render()] = {
            "choice": choice,
            "wall_us": {str(k): float(v) for k, v in wall_us.items()}}

    def lookup(self, key: TuneKey) -> str | None:
        """The measured winner for ``key``, or None (-> caller's default)."""
        e = self.entries.get(key.render())
        return None if e is None else e["choice"]

    def choices(self) -> dict[str, str]:
        """key-string -> choice, for round-trip / diff comparisons."""
        return {k: v["choice"] for k, v in sorted(self.entries.items())}

    def merge(self, other: "TuningTable") -> None:
        """Fold ``other``'s entries in (other wins on key collisions)."""
        self.entries.update(other.entries)

    def save(self, path: str | Path | None = None) -> Path:
        path = Path(path) if path is not None else default_path(self.backend)
        payload = {"version": self.version, "backend": self.backend,
                   "device_kind": self.device_kind,
                   "torch_version": self.torch_version,
                   "entries": {k: self.entries[k]
                               for k in sorted(self.entries)}}
        path.write_text(json.dumps(payload, indent=2) + "\n")
        return path

    @classmethod
    def load(cls, path: str | Path) -> "TuningTable":
        """Load a persisted table; entries of another schema version are
        dropped (their keys' meaning may have changed), which the fallback
        contract turns into today's defaults."""
        raw = json.loads(Path(path).read_text())
        version = int(raw.get("version", 0))
        entries = raw.get("entries", {}) if version == SCHEMA_VERSION else {}
        for k in entries:
            TuneKey.parse(k)  # malformed keys fail loudly at load time
        return cls(backend=raw.get("backend", ""),
                   device_kind=raw.get("device_kind", ""),
                   torch_version=raw.get("torch_version", ""),
                   version=version, entries=entries)
