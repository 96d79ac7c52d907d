"""Checker TS — explicit random streams and no host clock in the solver's
layers (the counterpart of the reference's ``trace_safety``).

The port draws every pick, delay and test input from an explicit
``torch.Generator`` (or a seeded ``numpy.random.Generator``), so a run is
reproducible and two runs on the same seed draw the same streams.  Over
``src/repro_torch``:

* TS1 — a torch random call without ``generator=`` (``torch.rand*``,
  ``randint``, ``randperm``, ``multinomial``, ``normal``, ``bernoulli``,
  ``poisson``, their ``_like`` forms, and the in-place tensor methods
  ``normal_``, ``uniform_``, ``random_``, ``bernoulli_``, ``exponential_``
  …), the global torch seed (``torch.manual_seed``, ``torch.seed``,
  ``torch.cuda.manual_seed*``), global numpy state (``np.random.<fn>``
  other than the seeded ``default_rng(seed)`` and the generator classes)
  or the stdlib ``random`` module's global functions;
* TS2 — a host clock (``time.time``, ``time.perf_counter``,
  ``time.monotonic`` and their ``_ns`` forms, ``datetime.now`` …) in
  ``core/`` or ``kernels/``: a solver value must not depend on when it
  ran.

The reference's third rule, a Python branch on a traced value, has no
static counterpart: the port traces nothing, and what the rule guards
against on the card is a host synchronization inside a solve.
``chip_smoke.py`` covers that at run time, running the simulator's solves
under ``torch.cuda.set_sync_debug_mode("error")``, where any
synchronizing call raises.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.common import Finding, call_name, enclosing_symbols

NAME = "sync-safety"

TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "multinomial",
                "normal", "bernoulli", "poisson", "rand_like", "randn_like",
                "randint_like"}
TENSOR_RANDOM = {"normal_", "uniform_", "random_", "bernoulli_",
                 "exponential_", "geometric_", "cauchy_", "log_normal_"}
GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all", "torch.cuda.seed",
                "torch.cuda.seed_all", "torch.random.manual_seed"}
NP_EXPLICIT = {"default_rng", "Generator", "SeedSequence", "PCG64",
               "Philox", "SFC64", "MT19937", "BitGenerator"}
CLOCKS = {"time.time", "time.perf_counter", "time.monotonic",
          "time.process_time", "time.time_ns", "time.perf_counter_ns",
          "time.monotonic_ns", "time.process_time_ns", "datetime.now",
          "datetime.datetime.now", "datetime.utcnow",
          "datetime.datetime.utcnow"}
CLOCK_SCOPES = ("src/repro_torch/core/", "src/repro_torch/kernels/")


def _stdlib_random(tree: ast.AST) -> bool:
    return any(isinstance(n, ast.Import) and any(a.name == "random" and
                                                  a.asname is None
                                                  for a in n.names)
               for n in ast.walk(tree))


def check_file(path: str, tree: ast.AST, source: str) -> list[Finding]:
    owner = enclosing_symbols(tree)
    uses_random = _stdlib_random(tree)
    findings = []

    def report(code, node, message):
        findings.append(Finding(code, path, node.lineno,
                                owner.get(id(node), "<module>"), message))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        cn = call_name(node) or ""
        leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                else cn.split(".")[-1])
        kws = {kw.arg for kw in node.keywords}
        if cn.startswith("torch.") and cn.count(".") == 1 \
                and leaf in TORCH_RANDOM and "generator" not in kws:
            report("TS1", node, f"{cn}() without generator=: it draws from "
                   "torch's global stream")
        elif isinstance(node.func, ast.Attribute) and leaf in TENSOR_RANDOM \
                and "generator" not in kws:
            report("TS1", node, f".{leaf}() without generator=: it draws "
                   "from torch's global stream")
        elif cn in GLOBAL_SEEDS:
            report("TS1", node, f"{cn}() sets torch's global random state")
        elif cn.startswith(("np.random.", "numpy.random.")):
            if leaf not in NP_EXPLICIT or (leaf == "default_rng"
                                           and not node.args and not kws):
                report("TS1", node, f"{cn}() uses numpy's global (or an "
                       "unseeded) random state")
        elif uses_random and cn.startswith("random.") \
                and leaf not in ("Random", "SystemRandom"):
            report("TS1", node, f"{cn}() uses the random module's global "
                   "state")
        elif cn in CLOCKS and path.startswith(CLOCK_SCOPES):
            report("TS2", node, f"host clock {cn}() in the solver's layers")
    # a bare `from time import perf_counter` call shows as its leaf name
    if path.startswith(CLOCK_SCOPES):
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "time", "datetime"):
                for alias in node.names:
                    if f"{node.module}.{alias.name}" in CLOCKS or \
                            alias.name in ("perf_counter", "monotonic"):
                        report("TS2", node, f"imports the host clock "
                               f"{node.module}.{alias.name}")
    return findings

