"""The port's static checks: ``python -m repro_torch.analysis.lint``.

Runs every checker over the port's own files, diffs the findings against
the baseline (``lint_baseline.json`` beside this module), and reports:

* ``kernel_precision`` — ``src/repro_torch/csrc/*.cu`` and ``*.cuh`` (KP1-3),
  and ``src/repro_torch`` with ``chip_smoke.py`` (KP4);
* ``sync_safety`` — ``src/repro_torch`` (TS1, TS2);
* ``bitwise_pin`` — ``tests/test_torch_*.py`` and ``chip_smoke.py`` (BP1, BP2);
* ``dispatch`` — ``src/repro_torch`` (DX1-6);
* ``dead_modules`` — ``src/repro_torch``, rooted also at ``chip_smoke.py``'s
  imports (DM1).

It never reads the reference's files or its ``lint-baseline.json``.

Modes:

* default — print every finding (baselined ones marked), exit 0;
* ``--fail-on-new`` — exit 1 if a finding's key is not in the baseline, or
  a baseline entry has no justification;
* ``--write-baseline`` — rewrite the baseline from the tree, keeping the
  justifications of the keys that remain (new keys get a placeholder that
  ``--fail-on-new`` refuses until it is replaced by a reason);
* ``--json`` — the findings as JSON.

Keys are ``code:path:symbol`` with no line numbers, so an entry survives
edits elsewhere in its file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import (bitwise_pin, dead_modules, dispatch,
                                  kernel_precision, sync_safety)
from repro_torch.analysis.common import (Finding, iter_files, parse_file, rel,
                                         repo_root)

BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "lint_baseline.json")
SMOKE = "chip_smoke.py"
UNJUSTIFIED = "TODO: justify or fix"


def parse_tree(root: str) -> dict[str, dict[str, tuple]]:
    """``{"src": {path: (tree, source)}, "tests": ..., "smoke": ...,
    "csrc": {path: source}}``, paths repo-relative."""
    def parsed(paths):
        out = {}
        for path in paths:
            r = rel(root, path)
            try:
                out[r] = parse_file(path)
            except SyntaxError as e:
                out[r] = (None, "")
                print(f"repro_torch lint: cannot parse {r}: {e}",
                      file=sys.stderr)
        return out

    src = os.path.join(root, "src", "repro_torch")
    tests = os.path.join(root, "tests")
    smoke = os.path.join(root, SMOKE)
    csrc = {}
    for path in iter_files(os.path.join(src, "csrc"), (".cu", ".cuh")):
        with open(path, encoding="utf-8") as f:
            csrc[rel(root, path)] = f.read()
    return {
        "src": parsed(iter_files(src, (".py",))),
        "tests": parsed(p for p in (iter_files(tests, (".py",))
                                    if os.path.isdir(tests) else [])
                        if os.path.basename(p).startswith("test_torch_")),
        "smoke": parsed([smoke] if os.path.exists(smoke) else []),
        "csrc": csrc,
    }


def run_checkers(root: str) -> list[Finding]:
    trees = parse_tree(root)
    findings: list[Finding] = []
    for path, source in sorted(trees["csrc"].items()):
        findings += kernel_precision.check_cuda(path, source)
    for checker, scopes in ((kernel_precision, ("src", "smoke")),
                            (sync_safety, ("src",)),
                            (bitwise_pin, ("tests", "smoke"))):
        for scope in scopes:
            for path, (tree, source) in sorted(trees[scope].items()):
                if tree is not None:
                    findings += checker.check_file(path, tree, source)
    src = {p: ts for p, ts in trees["src"].items() if ts[0] is not None}
    findings += dispatch.check_repo(root, src)
    findings += dead_modules.check_repo(root, src, trees["smoke"].get(SMOKE))
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.symbol))
    return findings


def load_baseline(path: str) -> dict[str, str]:
    """key -> justification."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {e["key"]: e.get("justification", "") for e in data["findings"]}


def write_baseline(path: str, findings: list[Finding],
                   old: dict[str, str]) -> None:
    entries = {}
    for f in findings:
        entries.setdefault(f.key, {"key": f.key, "message": f.message,
                                   "justification": old.get(f.key,
                                                            UNJUSTIFIED)})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"findings": [entries[k] for k in sorted(entries)]}, fh,
                  indent=2, sort_keys=True)
        fh.write("\n")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static checks of the PyTorch/CUDA port")
    ap.add_argument("--root", default=None,
                    help="repository root (default: found from this file)")
    ap.add_argument("--baseline", default=None,
                    help="baseline path (default: lint_baseline.json beside "
                    "this module)")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 on a finding not in the baseline or an "
                    "unjustified baseline entry")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the tree")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the findings as JSON")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else repo_root()
    baseline_path = args.baseline or BASELINE_FILE
    baseline = load_baseline(baseline_path)
    findings = run_checkers(root)

    if args.write_baseline:
        write_baseline(baseline_path, findings, baseline)
        print(f"repro_torch lint: wrote {len({f.key for f in findings})} "
              f"baseline entries to {baseline_path}")
        return 0

    if args.as_json:
        print(json.dumps([{
            "code": f.code, "path": f.path, "line": f.line,
            "symbol": f.symbol, "message": f.message, "key": f.key,
            "baselined": f.key in baseline} for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render() + (" [baselined]" if f.key in baseline else ""))
    new = [f for f in findings if f.key not in baseline]
    stale = sorted(set(baseline) - {f.key for f in findings})
    unjustified = sorted(k for k, why in baseline.items()
                         if not why.strip() or why == UNJUSTIFIED)
    if not args.as_json:
        print(f"repro_torch lint: {len(findings)} finding(s), {len(new)} new, "
              f"{len(findings) - len(new)} baselined, {len(stale)} stale "
              "baseline entr(y/ies)")
        for key in stale:
            print(f"repro_torch lint: stale baseline entry (no longer fires, "
                  f"remove it): {key}")
    if args.fail_on_new and (new or unjustified):
        for key in unjustified:
            print(f"repro_torch lint: baseline entry without a "
                  f"justification: {key}", file=sys.stderr)
        print(f"repro_torch lint: FAIL — {len(new)} new finding(s), "
              f"{len(unjustified)} unjustified baseline entr(y/ies)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
