"""The port's static checks (the counterpart of ``src/repro/analysis``):
the conventions the port's correctness rests on, checked mechanically.

* ``lint``             — the runner (``python -m repro_torch.analysis.lint
  [--fail-on-new] [--write-baseline] [--json]``) and its baseline,
  ``lint_baseline.json`` beside it, every entry with its reason;
* ``kernel_precision`` — KP: bf16 values widened by ``to_f32`` and int16
  ids widened to ``int`` at the load, no 16-bit arithmetic in
  ``csrc/*.cu``; TF32 never switched on in the Python;
* ``dispatch``         — DX: the distributed strategy table and its
  capability sets complete, guarded and single-sourced; the CSR matvec
  variant chosen through the tuning table;
* ``bitwise_pin``      — BP: a test or ``chip_smoke.py`` check that says
  "bitwise" compares exactly;
* ``dead_modules``     — DM: every module reached from an entry point;
* ``sync_safety``      — TS: random streams from explicit generators, no
  host clock in ``core/`` or ``kernels/``.

The reference's ``pytree_purity`` checker is answered, not ported: the
port registers no pytrees (its operators are plain classes, and nothing is
traced or hashed as a tree), so there is no aux data to keep pure.

The checks are pure AST and text scans and import only the standard
library and each other: neither torch nor ``repro``.  (``python -m``
imports the parent package ``repro_torch`` first, which imports torch;
the checks themselves run without it.)
"""
from repro_torch.analysis.common import Finding

__all__ = ["Finding"]
