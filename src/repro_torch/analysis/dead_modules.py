"""Checker DM — modules of ``repro_torch`` that no entry point reaches.

Reachability over the ``repro_torch.*`` import graph (an edge ``a -> b``
when ``a`` imports ``b``, ``from pkg import sub`` included; a module
reaches its enclosing packages).  The roots:

* the port's surface: ``repro_torch.core``, ``repro_torch.kernels``,
  every module of ``repro_torch.launch``, ``repro_torch.serve``,
  ``repro_torch.optim`` and ``repro_torch.analysis.lint``;
* every ``repro_torch.tune``, ``repro_torch.paper`` and
  ``repro_torch.examples`` module that runs as ``python -m`` (it has an
  ``if __name__ == "__main__":`` block);
* every module ``chip_smoke.py`` imports, the imports inside its
  embedded child-process scripts included.

Tests do not keep a module alive: a module only tests import is dead code
with a test suite attached.

* DM1 — a module under ``src/repro_torch`` that no root reaches.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.common import Finding, direct_imports, module_name_for

NAME = "dead-modules"

PACKAGE = "repro_torch"
ROOT_MODULES = ("repro_torch.core", "repro_torch.kernels", "repro_torch.serve",
                "repro_torch.optim", "repro_torch.analysis.lint")
ROOT_PREFIXES = ("repro_torch.launch.",)
CLI_PREFIXES = ("repro_torch.tune.", "repro_torch.paper.",
                "repro_torch.examples.")
_STR_IMPORT = re.compile(
    r"^\s*(?:from\s+(repro_torch(?:\.\w+)*)\s+import\s+([\w, ()]+)"
    r"|import\s+(repro_torch(?:\.\w+)*))", re.MULTILINE)


def string_imports(tree: ast.AST) -> set[str]:
    """``repro_torch`` imports inside string constants (child-process
    scripts)."""
    found: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and PACKAGE in node.value:
            for m in _STR_IMPORT.finditer(node.value):
                if m.group(3):
                    found.add(m.group(3))
                    continue
                found.add(m.group(1))
                for name in m.group(2).strip("()").split(","):
                    name = name.strip().split(" as ")[0]
                    if name.isidentifier():
                        found.add(f"{m.group(1)}.{name}")
    return found


def _resolve(name: str, modules: set[str]) -> str | None:
    parts = name.split(".")
    while parts:
        cand = ".".join(parts)
        if cand in modules:
            return cand
        parts.pop()
    return None


def _runs_as_main(tree: ast.AST) -> bool:
    return any(isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
               and isinstance(node.test.left, ast.Name)
               and node.test.left.id == "__name__"
               for node in getattr(tree, "body", []))


def reachable(parsed: dict, extra_roots: set[str]) -> tuple[dict, set[str]]:
    """(module -> path, the modules reached from the roots and
    ``extra_roots``)."""
    modules: dict[str, str] = {}
    graph: dict[str, set[str]] = {}
    trees = {}
    for path, (tree, _src) in parsed.items():
        mod = module_name_for(path)
        if mod is not None and mod.split(".")[0] == PACKAGE:
            modules[mod] = path
            trees[mod] = tree
    known = set(modules)
    for mod, tree in trees.items():
        edges = {t for t in (_resolve(n, known)
                             for n in direct_imports(tree, PACKAGE)) if t}
        parts = mod.split(".")
        edges |= {".".join(parts[:i]) for i in range(1, len(parts))} & known
        graph[mod] = edges
    roots = {m for m in known
             if m in ROOT_MODULES or m.startswith(ROOT_PREFIXES)
             or (m.startswith(CLI_PREFIXES) and _runs_as_main(trees[m]))}
    roots |= {t for t in (_resolve(n, known) for n in extra_roots) if t}
    reached: set[str] = set()
    frontier = sorted(roots)
    while frontier:
        mod = frontier.pop()
        if mod not in reached:
            reached.add(mod)
            frontier.extend(graph.get(mod, ()))
    return modules, reached


def check_repo(root: str, parsed: dict, smoke: tuple | None = None
               ) -> list[Finding]:
    """``parsed``: the port's files; ``smoke``: ``chip_smoke.py``'s (tree,
    source), whose imports are roots."""
    extra = set()
    if smoke is not None and smoke[0] is not None:
        extra = direct_imports(smoke[0], PACKAGE) | string_imports(smoke[0])
    modules, reached = reachable(parsed, extra)
    return [Finding("DM1", modules[mod], 1, mod,
                    f"module {mod} is reached from no entry point of the "
                    "port (core, kernels, launch.*, serve, optim, "
                    "analysis.lint, the tune, paper and example CLIs, "
                    "chip_smoke.py): wire it "
                    "in, or remove it")
            for mod in sorted(set(modules) - reached)]
