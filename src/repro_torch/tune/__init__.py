"""``repro_torch.tune`` — the tuning table and measured dispatch (port of
``repro.tune``).

``table``    — the versioned, backend-keyed ``TUNE_torch_<backend>.json``
               schema (``TuningTable`` / ``TuneKey`` / shape bucketing);
``runtime``  — the process-wide active table and the lookups the dispatch
               seams call (``matvec_variant``, ``tuned_rows_per_panel``);
``autotune`` — the sweep/show/diff CLI
               (``python -m repro_torch.tune.autotune``).

Contract: explicit caller choices are never overridden; a missing table
entry (or no table) runs today's default, bitwise unchanged — the table
only chooses *which* implementation runs.
"""
from repro_torch.tune.runtime import (active_table, matvec_variant,
                                      set_active_table, tuned_rows_per_panel,
                                      use_table)
from repro_torch.tune.table import TuneKey, TuningTable, shape_bucket

__all__ = [
    "TuneKey",
    "TuningTable",
    "active_table",
    "matvec_variant",
    "set_active_table",
    "shape_bucket",
    "tuned_rows_per_panel",
    "use_table",
]
