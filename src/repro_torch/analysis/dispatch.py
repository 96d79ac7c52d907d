"""Checker DX — the distributed engine's strategy table and capability
sets (``core/distributed.py``), and the tuned CSR matvec seam.

The distributed engine dispatches on ``(action, format, sync)`` through
``_DISTRIBUTED_STRATEGIES`` and gates its optional features through the
capability sets ``_OVERLAP_STRATEGIES`` and ``_COMPRESS_STRATEGIES`` (the
port has one engine, so no ``_FUSED_STRATEGIES``):

* DX1 — a capability-set member that is no strategy kind of the table (a
  stale or misspelled entry gates nothing);
* DX2 — a dispatch hole: an ``(action, format)`` pair whose action and
  format both appear in the table but that has no row under any sync;
* DX3 — a capability set with no fallback guard: no
  ``if ... kind not in <SET>:`` whose body warns (a ``_warn_*`` helper,
  ``_warn_overlap_fallback`` / ``_warn_compress_fallback``, or
  ``warnings.warn``);
* DX4 — a duplicated capability literal anywhere in ``src/repro_torch``: a
  tuple/set/list of strings equal (as a set) to a named constant of the
  table's module, or the same literal of three or more strings at two or
  more sites;
* DX5 — the dispatch-miss error does not enumerate the table (no
  ``sorted(_DISTRIBUTED_STRATEGIES)`` in the function doing the ``.get``);
* DX6 — a function that references two or more members of the tuned CSR
  matvec quartet (``spmv_csr``, ``spmv_csr_prefetch``, ``spmv_csr_sliced``,
  ``spmv_csr_sliced_prefetch``) chooses between measured variants, and
  must consult the tuning table (``tune/runtime.py::matvec_variant`` or
  ``tuned_rows_per_panel``) or carry a baseline entry.  ``tune/`` (the
  table's machinery) and ``kernels/`` (where the variants are defined) are
  exempt.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.common import (Finding, call_name, const_str_tuple,
                                         dotted_name)

NAME = "dispatch"

TABLE_NAME = "_DISTRIBUTED_STRATEGIES"
CONST_NAME = re.compile(r"^_?[A-Z][A-Z0-9_]*$")
VARIANT_FAMILIES = {
    "csr_matvec": frozenset({"spmv_csr", "spmv_csr_prefetch",
                             "spmv_csr_sliced", "spmv_csr_sliced_prefetch"}),
}
TUNE_LOOKUPS = frozenset({"matvec_variant", "tuned_rows_per_panel"})
DX6_EXEMPT = ("src/repro_torch/tune/", "src/repro_torch/kernels/")


def _module_constants(tree):
    """ALL_CAPS module-level string-tuple constants: name -> (values,
    line, value node)."""
    out = {}
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and CONST_NAME.match(node.targets[0].id):
            vals = const_str_tuple(node.value)
            if vals:
                out[node.targets[0].id] = (vals, node.lineno, node.value)
    return out


def _parse_table(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == TABLE_NAME \
                and isinstance(node.value, ast.Dict):
            table = {}
            for k, v in zip(node.value.keys, node.value.values):
                kt = const_str_tuple(k)
                if kt and len(kt) == 3 and isinstance(v, ast.Constant):
                    table[kt] = v.value
            return table
    return None


def _has_fallback_guard(tree, set_name: str) -> bool:
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        if not any(isinstance(sub, ast.Compare)
                   and any(isinstance(op, ast.NotIn) for op in sub.ops)
                   and any(dotted_name(c) == set_name for c in sub.comparators)
                   for sub in ast.walk(node.test)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                cn = call_name(sub) or ""
                if cn == "warnings.warn" or cn.split(".")[-1].startswith("_warn_"):
                    return True
    return False


def check_repo(root: str, parsed: dict) -> list[Finding]:
    findings: list[Finding] = []
    table_path = table = table_tree = None
    for path, (tree, _src) in sorted(parsed.items()):
        t = _parse_table(tree)
        if t is not None:
            table_path, table, table_tree = path, t, tree
            break
    if table is None:
        return findings
    constants = _module_constants(table_tree)
    kinds = set(table.values())
    cap_sets = {n: v for n, (v, _ln, _node) in constants.items()
                if n.endswith("_STRATEGIES")}
    for set_name, members in sorted(cap_sets.items()):
        for m in members:
            if m not in kinds:
                findings.append(Finding(
                    "DX1", table_path, constants[set_name][1], set_name,
                    f"{m!r} is no strategy kind of {TABLE_NAME} (kinds: "
                    f"{sorted(kinds)}): a stale entry gates nothing"))
    actions = {a for (a, _f, _s) in table}
    formats = {f for (_a, f, _s) in table}
    covered = {(a, f) for (a, f, _s) in table}
    for a in sorted(actions):
        for f in sorted(formats):
            if (a, f) not in covered:
                findings.append(Finding(
                    "DX2", table_path, 0, f"{TABLE_NAME}[{a},{f}]",
                    f"dispatch hole: action={a!r} and format={f!r} both "
                    "appear in the table but the pair has no row under any "
                    "sync"))
    for set_name in sorted(cap_sets):
        if not _has_fallback_guard(table_tree, set_name):
            findings.append(Finding(
                "DX3", table_path, constants[set_name][1], set_name,
                f"no `kind not in {set_name}` guard that warns: a request "
                "outside the set would be ignored or crash"))
    for fn in ast.walk(table_tree):
        if not isinstance(fn, ast.FunctionDef) or not any(
                isinstance(n, ast.Call) and call_name(n) == f"{TABLE_NAME}.get"
                for n in ast.walk(fn)):
            continue
        if not any(isinstance(n, ast.Call) and call_name(n) == "sorted"
                   and n.args and dotted_name(n.args[0]) == TABLE_NAME
                   for n in ast.walk(fn)):
            findings.append(Finding(
                "DX5", table_path, fn.lineno, fn.name,
                f"dispatches by {TABLE_NAME}.get but its miss path never "
                f"enumerates sorted({TABLE_NAME})"))
    findings += _duplicated_literals(parsed, constants, table_path)
    findings += _variant_choices(parsed)
    return findings


def _duplicated_literals(parsed, constants, table_path) -> list[Finding]:
    findings = []
    tracked = {n: frozenset(v) for n, (v, _ln, _node) in constants.items()
               if len(v) >= 2}
    defining = {id(sub) for _n, (_v, _ln, node) in constants.items()
                for sub in ast.walk(node)}
    occurrences: dict[frozenset, list[tuple[str, int]]] = {}
    for path, (tree, _src) in sorted(parsed.items()):
        consumed: set[int] = set()
        for node in ast.walk(tree):
            if id(node) in consumed:
                continue
            vals = const_str_tuple(node)
            if not vals or len(vals) < 2:
                continue
            if isinstance(node, ast.Call):
                consumed.add(id(node.args[0]))
            vset = frozenset(vals)
            hit = False
            for cname, cvals in sorted(tracked.items()):
                if vset != cvals:
                    continue
                hit = True
                if path == table_path and id(node) in defining:
                    continue
                findings.append(Finding(
                    "DX4", path, node.lineno, f"literal=={cname}",
                    f"string literal duplicating {cname} ({sorted(vset)}): "
                    "import the constant so the copies cannot drift"))
            if not hit and len(vset) >= 3:
                occurrences.setdefault(vset, []).append((path, node.lineno))
    for vset, sites in sorted(occurrences.items(), key=lambda kv: sorted(kv[0])):
        if len(sites) < 2:
            continue
        for path, line in sites:
            findings.append(Finding(
                "DX4", path, line, f"literal={'|'.join(sorted(vset))}",
                f"string-tuple literal {sorted(vset)} repeated at "
                f"{len(sites)} sites: hoist it to one named constant"))
    return findings


def _variant_choices(parsed) -> list[Finding]:
    findings = []
    for path, (tree, _src) in sorted(parsed.items()):
        if path.startswith(DX6_EXEMPT):
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            referenced, consults = set(), False
            for node in ast.walk(fn):
                dn = dotted_name(node)
                if dn:
                    referenced.add(dn.split(".")[-1])
                if isinstance(node, ast.Call) and \
                        (call_name(node) or "").split(".")[-1] in TUNE_LOOKUPS:
                    consults = True
            if consults:
                continue
            for fam, members in sorted(VARIANT_FAMILIES.items()):
                hit = sorted(referenced & members)
                if len(hit) >= 2:
                    findings.append(Finding(
                        "DX6", path, fn.lineno, fn.name,
                        f"references {len(hit)} members of the tuned {fam!r} "
                        f"family ({hit}) without a tuning-table lookup "
                        f"({'/'.join(sorted(TUNE_LOOKUPS))})"))
    return findings
