"""Shared infrastructure of the port's static checks (the port's own copy
of what it needs from ``src/repro/analysis/common.py``; the port imports
nothing of ``repro``).

A checker is a module exposing ``NAME`` (its slug) and one or more of
``check_file(path, tree, source)`` (a Python file's AST),
``check_cuda(path, source)`` (a ``csrc`` source's text) and
``check_repo(root, parsed)`` (the whole tree: import graphs, cross-file
tables); each returns a list of :class:`Finding`.  A finding's key is
``code:path:symbol``, with no line number, so a baseline entry survives
edits elsewhere in its file.

Everything here is the standard library only: the pass reads the port,
it never imports it.
"""
from __future__ import annotations

import ast
import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation; ``line`` is for display only."""
    code: str        # e.g. "KP1"
    path: str        # repo-relative, forward slashes
    line: int
    symbol: str      # owning function / class / module / table entry
    message: str

    @property
    def key(self) -> str:
        return f"{self.code}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{self.symbol}] {self.message}"


def repo_root(start: str | None = None) -> str:
    """The nearest ancestor of ``start`` (default: this file) holding
    ``src/repro_torch``."""
    d = os.path.abspath(start or os.path.dirname(__file__))
    while True:
        if os.path.isdir(os.path.join(d, "src", "repro_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise FileNotFoundError(
                "could not locate the repository root (no src/repro_torch "
                f"above {start or os.path.dirname(__file__)!r})")
        d = parent


def rel(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def iter_files(directory: str, suffixes: tuple[str, ...]) -> list[str]:
    """Files under ``directory`` ending in one of ``suffixes``, sorted,
    skipping caches and hidden directories."""
    out = []
    for base, subdirs, files in os.walk(directory):
        subdirs[:] = sorted(s for s in subdirs
                            if s != "__pycache__" and not s.startswith("."))
        out.extend(os.path.join(base, f) for f in sorted(files)
                   if f.endswith(suffixes))
    return out


def parse_file(path: str) -> tuple[ast.AST, str]:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return ast.parse(source, filename=path), source


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted_name(node.func)


def const_str_tuple(node: ast.AST) -> tuple[str, ...] | None:
    """The value of a tuple/list/set display of string constants, or of a
    ``frozenset(...)`` call around one."""
    if (isinstance(node, ast.Call) and call_name(node) == "frozenset"
            and len(node.args) == 1):
        node = node.args[0]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
                return None
            vals.append(elt.value)
        return tuple(vals)
    return None


def module_name_for(path: str) -> str | None:
    """Dotted module name of a repo-relative file under ``src/``."""
    if not path.startswith("src/") or not path.endswith(".py"):
        return None
    mod = path[len("src/"):-len(".py")].replace("/", ".")
    return mod.removesuffix(".__init__")


def direct_imports(tree: ast.AST, package: str) -> set[str]:
    """Every ``package``-rooted name a tree imports: ``from p.x import y``
    gives ``p.x`` and ``p.x.y`` (``y`` may be a submodule; the graph keeps
    only names that are modules)."""
    found: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == package:
                    found.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] == package:
                found.add(node.module)
                for alias in node.names:
                    found.add(f"{node.module}.{alias.name}")
    return found


def enclosing_symbols(tree: ast.AST) -> dict[int, str]:
    """``id(node) -> name`` of the innermost function or class holding each
    node (``<module>`` at top level)."""
    owner: dict[int, str] = {}

    def walk(node, name):
        for child in ast.iter_child_nodes(node):
            inner = name
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                inner = child.name
            owner[id(child)] = inner
            walk(child, inner)
    walk(tree, "<module>")
    return owner
