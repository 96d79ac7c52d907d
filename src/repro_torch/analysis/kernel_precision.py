"""Checker KP — the kernels' precision contract (DESIGN.md §4 and §7):
coefficients may be stored as bf16 and column ids as int16, and both are
widened on load; every product and sum accumulates in f32; TF32 stays off.

Over ``src/repro_torch/csrc/*.cu`` and ``*.cuh`` (``check_cuda``), a
token and regex scan of the C++ text, function by function:

* KP1 — a load through a value-typed pointer (``V*`` with ``V`` the
  kernels' value template parameter, ``__nv_bfloat16*``, ``__half*``;
  ``const`` or not) that is not the argument of ``to_f32(...)``
  (``csrc/common.cuh``), so a bf16 value could reach arithmetic as bf16.
  A load copied as it is into a subscript store (``dst[i] = src[j];``, a
  staging copy into shared memory) is not arithmetic and passes, as does
  an element passed to a function of the same file that takes it by
  non-const reference (a store through it);
* KP2 — 16-bit arithmetic: ``__hadd``, ``__hsub``, ``__hmul``, ``__hdiv``,
  ``__hfma`` and their ``2`` forms, or a 16-bit local (``__nv_bfloat16``,
  ``__half``, their ``2`` pairs, ``V``) updated by ``+=``, ``-=``, ``*=``,
  ``/=``, the shape of a 16-bit accumulator;
* KP3 — a load through an index-typed pointer (``I*`` with ``I`` the index
  template parameter, ``int16_t*``, ``short*``) that is not widened at the
  load (``(int)``, ``(int32_t)``, ``(int64_t)``, ``(long long)``,
  ``(size_t)`` or ``static_cast<int...>``), so an int16 id could reach an
  index or address computation unwidened.

What the scan sees: comments and string literals are blanked first;
function bodies are found by matching braces after a parameter list;
pointer names come from the parameters and local declarations of each
function; a load is ``name[...]``.  What it cannot see: loads through
``*p`` or ``p->``, a pointer whose type is hidden behind a typedef or
``auto``, a value loaded into a local and widened later (flagged, though
harmless), a value copied into a 16-bit local and used in arithmetic
there (KP2 sees only compound assignments), inline PTX, and macros
expanded anywhere but in their own text.

Over the port's Python (``src/repro_torch`` and ``chip_smoke.py``,
``check_file``):

* KP4 — TF32 switched on: ``... .allow_tf32 = True``,
  ``set_float32_matmul_precision`` with anything but ``"highest"``, or a
  Triton ``tl.dot`` without ``input_precision="ieee"`` (Triton's f32 dot
  defaults to TF32 on Hopper).
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.common import (Finding, call_name, dotted_name,
                                         enclosing_symbols)

NAME = "kernel-precision"

_VALUE_T = r"(?:V|__nv_bfloat16|__half|nv_bfloat16|half)"
_INDEX_T = r"(?:I|int16_t|uint16_t|short|unsigned\s+short)"
_PTR_DECL = r"\b{t}\s*\*\s*(?:const\s+)?(?:__restrict__\s+)?(\w+)"
VALUE_PTR = re.compile(_PTR_DECL.format(t=_VALUE_T))
INDEX_PTR = re.compile(_PTR_DECL.format(t=_INDEX_T))
WIDEN = re.compile(r"(?:\(\s*(?:int|int32_t|int64_t|long\s+long|size_t)\s*\)"
                   r"|static_cast<\s*(?:int|int32_t|int64_t|long\s+long|size_t)"
                   r"\s*>\s*\()\s*$")
HALF_MATH = re.compile(
    r"\b(__h(?:add|sub|mul|div|fma)2?(?:_sat|_rn|_relu)?)\s*\(")
HALF_LOCAL = re.compile(
    r"\b(?:__nv_bfloat162?|__half2?|nv_bfloat162?|half2?|V)\s+(\w+)\s*[=;\[(,]")
# the head of a statement that stores into a subscript, after an optional
# `else` / `if (...)`
STORE = re.compile(r"\s*(?:else\s*)?(?:if\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
                   r"\w+(\s*\[[^;]*\])+\s*=(?!=)")
# a parameter taken by non-const reference: a function writing through it
REF_PARAM = re.compile(r"(?<!const )\b(?:float|V|__nv_bfloat16|__half)\s*&\s*\w+")
KEYWORDS = {"if", "for", "while", "switch", "catch", "return", "sizeof",
            "decltype", "alignof", "static_assert", "__launch_bounds__"}


def strip_cpp(text: str) -> str:
    """The text with comments and string/char literals blanked (newlines
    kept, so offsets map to the same lines)."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", text[i:j]))
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(c + " " * (min(j, n) - i - 1) + (c if j < n else ""))
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _match(text: str, i: int, open_c: str, close_c: str, step: int) -> int:
    """Index of the bracket matching ``text[i]``, walking by ``step``."""
    depth = 0
    while 0 <= i < len(text):
        if text[i] == open_c:
            depth += 1
        elif text[i] == close_c:
            depth -= 1
            if depth == 0:
                return i
        i += step
    return -1


def functions(text: str) -> list[tuple[str, str, int, int]]:
    """``(name, params, body_start, body_end)`` of every outermost function
    definition of a stripped source (a ``{`` right after a parameter list
    whose name is not a keyword)."""
    out = []
    i = 0
    while True:
        i = text.find("{", i)
        if i < 0:
            return out
        head = text[:i].rstrip()
        head = re.sub(r"\bconst\s*$", "", head).rstrip()
        name = None
        if head.endswith(")"):
            p0 = _match(head, len(head) - 1, ")", "(", -1)
            m = re.search(r"(\w+)\s*$", head[:p0]) if p0 > 0 else None
            if m and m.group(1) not in KEYWORDS:
                name, params = m.group(1), head[p0 + 1:-1]
        end = _match(text, i, "{", "}", 1)
        if end < 0:
            return out
        if name is not None:
            out.append((name, params, i, end))
            i = end + 1
        else:
            i += 1


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _is_store(body: str, close: int) -> bool:
    rest = body[close + 1:].lstrip()
    return rest.startswith("=") and not rest.startswith("==")


def _is_copy(body: str, start: int, close: int) -> bool:
    """Whether the load ``body[start:close + 1]`` is copied as it is into
    a subscript store (``dst[i] = src[j];``, or a branch of a ternary on
    the right of one): a staging copy, no arithmetic."""
    before = body[:start].rstrip()
    after = body[close + 1:].lstrip()
    if not (after.startswith((";", ":")) and (
            before.endswith(("?", ":")) or (
                before.endswith("=") and not before.endswith(
                    ("==", "<=", ">=", "!="))))):
        return False
    s = max(body.rfind(c, 0, start) for c in ";{}") + 1
    return STORE.match(body[s:start]) is not None


def check_cuda(path: str, source: str) -> list[Finding]:
    text = strip_cpp(source)
    findings = []
    fns = functions(text)
    writers = {name for name, params, _s, _e in fns if REF_PARAM.search(params)}

    def report(code, pos, symbol, message):
        findings.append(Finding(code=code, path=path, line=_line(text, pos),
                                symbol=symbol, message=message))

    for name, params, start, end in fns:
        body = text[start:end + 1]
        decls = params + "\n" + body
        values = set(VALUE_PTR.findall(decls))
        indices = set(INDEX_PTR.findall(decls))
        for ptr in sorted(values | indices):
            for m in re.finditer(rf"\b{ptr}\s*\[", body):
                close = _match(body, m.end() - 1, "[", "]", 1)
                if close < 0 or _is_store(body, close):
                    continue
                before = body[:m.start()].rstrip()
                written = re.search(r"(\w+)\s*\($", before)
                if ptr in values and not before.endswith("to_f32(") \
                        and not _is_copy(body, m.start(), close) \
                        and not (written and written.group(1) in writers):
                    report("KP1", start + m.start(), name,
                           f"load {ptr}[...] of a value-typed pointer is not "
                           "widened by to_f32() at the load: bf16 storage "
                           "would reach arithmetic as bf16")
                if ptr in indices and not WIDEN.search(before):
                    report("KP3", start + m.start(), name,
                           f"load {ptr}[...] of an index-typed pointer is not "
                           "widened to int at the load: an int16 id would "
                           "reach an index or address computation")
        for m in HALF_MATH.finditer(body):
            report("KP2", start + m.start(), name,
                   f"16-bit arithmetic {m.group(1)}(): products and sums "
                   "must accumulate in f32")
        for local in sorted(set(HALF_LOCAL.findall(body))):
            for m in re.finditer(rf"\b{local}\s*[-+*/]=", body):
                report("KP2", start + m.start(), name,
                       f"16-bit local {local!r} accumulates: accumulators "
                       "must be f32")
    for m in HALF_MATH.finditer(text):
        if not any(s <= m.start() <= e for _n, _p, s, e in fns):
            report("KP2", m.start(), "<file>",
                   f"16-bit arithmetic {m.group(1)}() outside a function")
    return findings


def _tf32_dot(node: ast.Call) -> bool:
    prec = {kw.arg: kw.value for kw in node.keywords}
    v = prec.get("input_precision")
    tf32 = prec.get("allow_tf32")
    if isinstance(tf32, ast.Constant) and tf32.value is True:
        return True
    return not (isinstance(v, ast.Constant) and v.value == "ieee")


def check_file(path: str, tree: ast.AST, source: str) -> list[Finding]:
    owner = enclosing_symbols(tree)
    findings = []
    for node in ast.walk(tree):
        msg = None
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) \
                and node.value.value is True and any(
                    (dotted_name(t) or "").endswith("allow_tf32")
                    for t in node.targets):
            msg = "allow_tf32 = True: f32 products would round to TF32"
        elif isinstance(node, ast.Call):
            cn = call_name(node) or ""
            if cn.endswith("set_float32_matmul_precision"):
                arg = node.args[0] if node.args else None
                if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                    msg = ("set_float32_matmul_precision other than "
                           "'highest': f32 products would round to TF32")
            elif cn in ("tl.dot", "triton.language.dot") and _tf32_dot(node):
                msg = ("tl.dot without input_precision='ieee': Triton's f32 "
                       "dot defaults to TF32")
        if msg:
            findings.append(Finding(code="KP4", path=path,
                                    line=getattr(node, "lineno", 0),
                                    symbol=owner.get(id(node), "<module>"),
                                    message=msg))
    return findings
