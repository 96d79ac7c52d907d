"""Checker BP — a claim of "bitwise" must be an exact comparison.

The port pins many results bitwise: a kernel's two paths, column 0 at
k = 51 against k = 1, chained serving chunks against the one-shot solve,
a2a against the psum.  A check that says "bitwise" but compares within a
tolerance keeps passing after the pin breaks.  Over ``tests/test_torch_*.py``:

* BP1 — a test whose name or docstring claims "bitwise" calls
  ``allclose`` / ``assert_allclose`` / ``isclose`` / ``assert_close``
  with tolerances other than ``rtol=0, atol=0``;
* BP2 — such a test performs no exact comparison at all: no
  ``torch.equal``, ``array_equal`` / ``assert_array_equal``, ``==``, or
  zero-tolerance ``allclose`` / ``torch.testing.assert_close(...,
  rtol=0, atol=0)``.

Over ``chip_smoke.py``, where a result is a ``check(condition, message)``:

* BP1 — a ``check`` whose message claims "bitwise" has a close call with
  nonzero tolerances in its condition;
* BP2 — it has no exact comparison in its condition, directly, through
  a helper of the same file whose body compares exactly (``bitwise(a,
  b)`` and its kin), or through the values assigned to a local name of
  the condition in the enclosing function (each looked through once).
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.common import Finding, call_name, enclosing_symbols

NAME = "bitwise-pin"

BITWISE = re.compile(r"bitwise|bit-for-bit|bit_for_bit", re.IGNORECASE)
EXACT_CALLS = {"equal", "array_equal", "assert_array_equal", "array_equiv"}
CLOSE_CALLS = {"allclose", "assert_allclose", "isclose", "assert_close"}


def _zero_tolerances(call: ast.Call) -> bool:
    tol = {kw.arg: kw.value for kw in call.keywords
           if kw.arg in ("rtol", "atol")}
    return len(tol) == 2 and all(isinstance(v, ast.Constant) and v.value == 0
                                 for v in tol.values())


def _scan(node: ast.AST, exact_helpers: set[str]) -> tuple[bool, list[ast.Call]]:
    """(whether ``node`` compares exactly, its close calls with nonzero
    tolerances)."""
    exact, loose = False, []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            cn = (call_name(sub) or "").split(".")[-1]
            if cn in EXACT_CALLS or cn in exact_helpers:
                exact = True
            elif cn in CLOSE_CALLS:
                if _zero_tolerances(sub):
                    exact = True
                else:
                    loose.append(sub)
        elif isinstance(sub, ast.Compare) and any(
                isinstance(op, ast.Eq) for op in sub.ops):
            exact = True
    return exact, loose


def _text(node: ast.AST) -> str:
    """The literal text of a string or f-string (placeholders dropped)."""
    parts = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            parts.append(sub.value)
    return " ".join(parts)


def _claims(fn: ast.FunctionDef) -> bool:
    doc = ast.get_docstring(fn)
    return bool(BITWISE.search(fn.name) or (doc and BITWISE.search(doc)))


def check_file(path: str, tree: ast.AST, source: str) -> list[Finding]:
    if path.endswith("chip_smoke.py"):
        return _check_smoke(path, tree)
    findings = []
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test")
                and _claims(fn)):
            continue
        exact, loose = _scan(fn, set())
        for call in loose:
            findings.append(Finding(
                "BP1", path, call.lineno, fn.name,
                f"{(call_name(call) or '').split('.')[-1]} with nonzero "
                "tolerances in a test claiming 'bitwise': compare with "
                "torch.equal / assert_array_equal (or rtol=0, atol=0)"))
        if not exact:
            findings.append(Finding(
                "BP2", path, fn.lineno, fn.name,
                "test claims 'bitwise' but compares nothing exactly"))
    return findings


def _assignments(fn: ast.AST) -> dict[str, list[ast.AST]]:
    """Local name -> the values assigned to it in ``fn`` (``=``, ``+=``,
    ``.append(...)`` / ``.extend(...)``)."""
    out: dict[str, list[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(node.value)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            out.setdefault(node.target.id, []).append(node.value)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("append", "extend") \
                and isinstance(node.func.value, ast.Name):
            out.setdefault(node.func.value.id, []).extend(node.args)
    return out


def _check_smoke(path: str, tree: ast.AST) -> list[Finding]:
    fns = [fn for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)]
    exact_helpers = {fn.name for fn in fns
                     if fn.name != "check" and _scan(fn, set()) == (True, [])}
    assigned = {id(fn): _assignments(fn) for fn in fns}
    parent_fn: dict[int, ast.AST] = {}
    for fn in fns:
        for sub in ast.walk(fn):
            parent_fn[id(sub)] = fn     # inner functions come later: innermost
    owner = enclosing_symbols(tree)
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and call_name(node) == "check"
                and len(node.args) >= 2 and BITWISE.search(_text(node.args[1]))):
            continue
        symbol = owner.get(id(node), "<module>")
        cond = [node.args[0]]
        local = assigned.get(id(parent_fn.get(id(node))), {})
        for sub in ast.walk(node.args[0]):
            if isinstance(sub, ast.Name):
                cond += local.get(sub.id, [])
        exact, loose = False, []
        for part in cond:
            e, lo = _scan(part, exact_helpers)
            exact, loose = exact or e, loose + lo
        for call in loose:
            findings.append(Finding(
                "BP1", path, call.lineno, symbol,
                "a check claiming 'bitwise' compares within a tolerance"))
        if not exact:
            findings.append(Finding(
                "BP2", path, node.lineno, symbol,
                "a check claiming 'bitwise' compares nothing exactly"))
    return findings
