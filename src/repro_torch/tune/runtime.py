"""Process-wide active tuning table and the dispatch-seam lookups (port of
``repro/tune/runtime.py``).

``CsrOp.matvec``'s variant and ``solve``'s ``rows_per_panel`` default ask
the helpers here.  Resolution order, everywhere:

1. an explicit caller choice (``variant=``, ``skip_empty=``, an integer
   ``rows_per_panel``) is forced, never overridden;
2. otherwise the active table's entry for the site's ``TuneKey`` wins;
3. no entry (or no table) -> today's default, bitwise unchanged.

The active table defaults to ``TUNE_torch_<backend>.json`` at the root of
the checkout (loaded once; a missing file means no table).  The
``REPRO_TORCH_TUNE_TABLE`` environment variable overrides it: a path loads
that file, ``off``/``none``/``0`` turns lookups off.  Tests and the
autotuner swap tables with ``use_table`` / ``set_active_table``.

The reference's fused-vs-scan lookups (``sweep_key``, ``fused_choice``,
``resolve_fused``) are not ported: the port has one engine, so there is
nothing to choose.
"""
from __future__ import annotations

import contextlib
import os

from repro_torch.tune.table import (TuneKey, TuningTable, default_path,
                                    shape_bucket, storage_key)

_ENV_VAR = "REPRO_TORCH_TUNE_TABLE"
_UNSET = object()           # "never set: load the default file lazily"
_active = _UNSET
_default_cache = _UNSET     # memoized default-table load (None = no file)


def _load_default() -> TuningTable | None:
    global _default_cache
    if _default_cache is _UNSET:
        env = os.environ.get(_ENV_VAR, "")
        if env.lower() in ("off", "none", "0"):
            _default_cache = None
        else:
            try:
                _default_cache = TuningTable.load(env or default_path())
            except (OSError, ValueError):
                _default_cache = None
    return _default_cache


def active_table() -> TuningTable | None:
    """The table lookups consult; None turns every lookup off (the
    defaults)."""
    if _active is _UNSET:
        return _load_default()
    return _active


def set_active_table(table: TuningTable | None):
    """Install ``table`` process-wide; returns the previous setting (which
    may be the internal "unset" sentinel — pass it back to restore)."""
    global _active
    prev = _active
    _active = table
    return prev


@contextlib.contextmanager
def use_table(table: TuningTable | None):
    """Scoped ``set_active_table`` (tests, the autotuner's forced runs)."""
    prev = set_active_table(table)
    try:
        yield table
    finally:
        set_active_table(prev)


def _op_storage_key(op) -> str:
    """'f32'/'bf16' from the operator's stored coefficient dtype."""
    for attr in ("data", "vals", "A_bands", "A"):
        leaf = getattr(op, attr, None)
        if leaf is not None:
            return storage_key(leaf.dtype)
    return "f32"


def matvec_key(op) -> TuneKey:
    return TuneKey("matvec", type(op).__name__, "-",
                   shape_bucket(op.shape[0]), _op_storage_key(op))


def panel_key(m: int, storage_dtype=None) -> TuneKey:
    return TuneKey("panel", "CsrOp", "-", shape_bucket(m),
                   storage_key(storage_dtype))


def matvec_variant(op) -> str | None:
    """The table's CSR matvec variant for ``op``'s bucket, or None."""
    t = active_table()
    return None if t is None else t.lookup(matvec_key(op))


def tuned_rows_per_panel(m: int, storage_dtype=None) -> int | None:
    """The table's ``rows_per_panel`` winner for an m-row CSR build, or
    None (-> the caller's default)."""
    t = active_table()
    choice = None if t is None else t.lookup(panel_key(m, storage_dtype))
    return None if choice is None else int(choice)
