"""The port's static checks (``src/repro_torch/analysis``): each checker
fires on a small bad snippet and stays silent on its clean twin, finding
keys carry no line numbers, the tree passes ``--fail-on-new`` against the
checked-in baseline while an unbaselined finding fails it, and the checks
run with torch and ``repro`` unimportable.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap

from repro_torch.analysis import (bitwise_pin, dead_modules, dispatch,
                                  kernel_precision, lint, sync_safety)
from repro_torch.analysis.common import Finding

ROOT = lint.repo_root()


def _codes(checker, source, path="src/repro_torch/fixture.py"):
    source = textwrap.dedent(source)
    return [f.code for f in checker.check_file(path, ast.parse(source), source)]


def _cuda_codes(source):
    return sorted(f.code for f in kernel_precision.check_cuda(
        "src/repro_torch/csrc/fixture.cu", textwrap.dedent(source)))


def _repo(checker, files, **kw):
    parsed = {p: (ast.parse(textwrap.dedent(s)), s) for p, s in files.items()}
    return [(f.code, f.symbol) for f in checker.check_repo("/fixture", parsed,
                                                           **kw)]


# -- KP: the kernels' precision contract -------------------------------------

BAD_CUDA = """
    template <typename V, typename I>
    __global__ void raw_kernel(const V* __restrict__ vals, const I* __restrict__ cols,
                               const float* x, float* y) {
      float acc = 0.f;
      acc = fmaf(vals[0], x[0], acc);           // KP1: bf16 reaches fmaf raw
      acc += x[cols[1]];                        // KP3: int16 id as an index
      y[0] = acc;
    }

    __global__ void half_kernel(const __nv_bfloat16* a, __nv_bfloat16* out) {
      __nv_bfloat16 s = __float2bfloat16(0.f);
      s += out[1];                              // KP2: a 16-bit accumulator
      out[0] = __hadd(s, out[2]);               // KP2: 16-bit arithmetic
    }
"""

CLEAN_CUDA = """
    // vals[0] * x in a comment is not code
    template <typename V, typename I>
    __global__ void good_kernel(const V* __restrict__ vals, const I* __restrict__ cols,
                                const float* x, float* y, V* stage) {
      float acc = 0.f;
      for (int w = 0; w < 4; ++w)
        acc = fmaf(to_f32(vals[w]), x[(size_t)(int)cols[w]], acc);
      stage[0] = vals[1];                       // a staging copy, no arithmetic
      y[0] = acc;
    }
"""


def test_kernel_precision_catches_bad_cuda():
    codes = _cuda_codes(BAD_CUDA)
    assert codes.count("KP1") >= 1, codes
    assert codes.count("KP2") == 2, codes
    assert codes.count("KP3") == 1, codes


def test_kernel_precision_clean_cuda_is_silent():
    assert _cuda_codes(CLEAN_CUDA) == []


def test_kernel_precision_names_the_function():
    found = kernel_precision.check_cuda("a.cu", textwrap.dedent(BAD_CUDA))
    assert {f.symbol for f in found} == {"raw_kernel", "half_kernel"}


def test_kernel_precision_sees_every_csrc_function():
    """The scan finds the sweep kernels (and the block mode's two designs:
    the ring's producer, row dot, consumer and kernel) in the real source,
    so a finding there would be named."""
    with open(os.path.join(ROOT, "src/repro_torch/csrc/sweep_csr.cu"),
              encoding="utf-8") as f:
        text = kernel_precision.strip_cpp(f.read())
    names = {name for name, *_ in kernel_precision.functions(text)}
    assert {"gs_step", "bgs_row_dot", "bgs_kernel", "rk_step",
            "launch_block_gs", "ring_produce", "ring_row_dot",
            "ring_consume", "bgs_ring_kernel", "launch_ring"} <= names


def test_tf32_switched_on_is_flagged():
    bad = """
        import torch
        import triton.language as tl

        def setup():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")

        def kernel(a, b):
            return tl.dot(a, b)
    """
    assert _codes(kernel_precision, bad) == ["KP4", "KP4", "KP4"]
    clean = """
        import torch
        import triton.language as tl

        def setup():
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")

        def kernel(a, b):
            return tl.dot(a, b, input_precision="ieee")
    """
    assert _codes(kernel_precision, clean) == []


# -- DX: the strategy table and the tuned seam --------------------------------

BAD_ENGINE = """
    _DISTRIBUTED_STRATEGIES = {
        ("gs", "DenseOp", "allgather"): "dense_gs",
        ("gs", "EllOp", "allgather"): "sparse_gs",
        ("rk", "DenseOp", "psum"): "dense_rk",
    }
    _OVERLAP_STRATEGIES = frozenset({"sparse_gs", "halo_gs"})

    def solve_distributed(op, action, sync, overlap):
        kind = _DISTRIBUTED_STRATEGIES.get((action, type(op).__name__, sync))
        if kind is None:
            raise NotImplementedError("gs/rk on dense or ell")
        return kind
"""

CLEAN_ENGINE = """
    import warnings
    _DISTRIBUTED_STRATEGIES = {
        ("gs", "DenseOp", "allgather"): "dense_gs",
        ("rk", "DenseOp", "psum"): "dense_rk",
    }
    _OVERLAP_STRATEGIES = frozenset({"dense_gs"})

    def solve_distributed(op, action, sync, overlap):
        kind = _DISTRIBUTED_STRATEGIES.get((action, type(op).__name__, sync))
        if kind is None:
            raise NotImplementedError(sorted(_DISTRIBUTED_STRATEGIES))
        if overlap and kind not in _OVERLAP_STRATEGIES:
            _warn_overlap_fallback(op, action, kind)
        return kind
"""

TABLE_PATH = "src/repro_torch/core/distributed.py"


def test_dispatch_catches_hole_stale_member_missing_guard_and_miss():
    found = _repo(dispatch, {TABLE_PATH: BAD_ENGINE})
    codes = {c for c, _ in found}
    assert ("DX2", "_DISTRIBUTED_STRATEGIES[rk,EllOp]") in found, found
    assert ("DX1", "_OVERLAP_STRATEGIES") in found, found   # halo_gs
    assert ("DX3", "_OVERLAP_STRATEGIES") in found, found
    assert ("DX5", "solve_distributed") in found, found
    assert codes == {"DX1", "DX2", "DX3", "DX5"}, found


def test_dispatch_clean_engine_is_silent():
    assert _repo(dispatch, {TABLE_PATH: CLEAN_ENGINE}) == []


def test_dispatch_catches_duplicated_literals():
    engine = CLEAN_ENGINE + '    COMPRESS_MODES = ("none", "bf16", "int8_ef")\n'
    cli = """
        def main(ap):
            ap.add_argument("--compress", choices=("none", "bf16", "int8_ef"))
            ap.add_argument("--a", choices=("x", "y", "z"))
            ap.add_argument("--b", choices=("z", "y", "x"))
    """
    found = _repo(dispatch, {TABLE_PATH: engine,
                             "src/repro_torch/launch/solve.py": cli})
    assert found.count(("DX4", "literal==COMPRESS_MODES")) == 1, found
    assert found.count(("DX4", "literal=x|y|z")) == 2, found


SEAM = """
    from repro_torch.kernels import ops

    def matvec(self, x):
        if self.skip:
            return ops.spmv_csr_sliced_prefetch(x)
        return ops.spmv_csr_sliced(x)
"""


def test_dispatch_catches_a_variant_choice_off_the_table():
    found = _repo(dispatch, {TABLE_PATH: CLEAN_ENGINE,
                             "src/repro_torch/core/operators.py": SEAM})
    assert found == [("DX6", "matvec")], found
    tuned = SEAM.replace("if self.skip:",
                         "if tune_runtime.matvec_variant(self) == 'p':")
    assert _repo(dispatch, {TABLE_PATH: CLEAN_ENGINE,
                            "src/repro_torch/core/operators.py": tuned}) == []
    assert _repo(dispatch, {TABLE_PATH: CLEAN_ENGINE,
                            "src/repro_torch/kernels/ops.py": SEAM,
                            "src/repro_torch/tune/autotune.py": SEAM}) == []


def test_dispatch_real_tree_has_only_the_baselined_bypass():
    trees = lint.parse_tree(ROOT)
    found = [(f.code, f.symbol) for f in dispatch.check_repo(
        ROOT, {p: t for p, t in trees["src"].items() if t[0] is not None})]
    assert found == [("DX6", "matvec_segsum")], found


# -- BP: exact claims compare exactly -----------------------------------------

def test_pin_checker_catches_tolerance_under_the_claim():
    src = """
        import torch

        def test_paths_bitwise():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

        def test_chunks_match():
            '''Chained chunks equal the one-shot solve bitwise.'''
            assert (a - b).abs().max() < 1e-6
    """
    assert _codes(bitwise_pin, src, "tests/test_torch_fixture.py") == [
        "BP1", "BP2", "BP2"]


def test_pin_checker_knows_torchs_exact_comparisons():
    src = """
        import torch

        def test_paths_bitwise():
            assert torch.equal(a, b)

        def test_cols_bitwise():
            torch.testing.assert_close(a, b, rtol=0, atol=0)

        def test_loose_is_fine_without_the_claim():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    """
    assert _codes(bitwise_pin, src, "tests/test_torch_fixture.py") == []


def test_pin_checker_reads_chip_smoke_checks():
    bad = """
        def main(torch):
            check(torch.allclose(a, b, rtol=1e-5), "paths bitwise equal")
            check(rel(a, b) <= 1e-5, f"column 0 bitwise at k={k}")
            check(rel(a, b) <= 1e-5, "within 1e-5 of the plain version")
    """
    assert _codes(bitwise_pin, bad, "chip_smoke.py") == ["BP1", "BP2", "BP2"]
    clean = """
        def bitwise(a, b):
            return torch.equal(a, b)

        def main(torch):
            same = [torch.equal(a, b)]
            same.append(x == y)
            check(all(same), "arrays bitwise")
            check(bitwise(a, b) and c == d, f"runs bitwise at k={k}")
    """
    assert _codes(bitwise_pin, clean, "chip_smoke.py") == []


# -- DM: dead modules ---------------------------------------------------------

def test_dead_modules_flags_what_no_root_reaches():
    files = {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/core/__init__.py": "from repro_torch.core import a",
        "src/repro_torch/core/a.py": "",
        "src/repro_torch/tune/__init__.py": "",
        "src/repro_torch/tune/cli.py": "if __name__ == '__main__':\n    pass\n",
        "src/repro_torch/tune/probe.py": "",
        "src/repro_torch/tune/helper.py": "",
        "src/repro_torch/old/__init__.py": "",
        "src/repro_torch/old/thing.py": "",
    }
    smoke = ast.parse('HEAD = "from repro_torch.tune import helper\\n"')
    found = {s for _c, s in _repo(dead_modules, files, smoke=(smoke, ""))}
    assert found == {"repro_torch.old", "repro_torch.old.thing",
                     "repro_torch.tune.probe"}, found


def test_dead_modules_real_tree_has_none():
    trees = lint.parse_tree(ROOT)
    src = {p: t for p, t in trees["src"].items() if t[0] is not None}
    assert dead_modules.check_repo(ROOT, src,
                                   trees["smoke"]["chip_smoke.py"]) == []


# -- TS: explicit streams, no host clock in the solver ------------------------

def test_sync_safety_catches_implicit_streams_and_clocks():
    src = """
        import random
        import time
        import numpy as np
        import torch

        def draw(n, g):
            a = torch.randint(0, n, (4,))          # TS1
            b = torch.empty(4).uniform_()          # TS1
            np.random.seed(0)                      # TS1
            c = random.random()                    # TS1
            torch.manual_seed(1)                   # TS1
            t = time.perf_counter()                # TS2 (core/)
            return torch.rand(4, generator=g), np.random.default_rng(3)
    """
    codes = _codes(sync_safety, src, "src/repro_torch/core/fixture.py")
    assert codes.count("TS1") == 5 and codes.count("TS2") == 1, codes
    # a clock outside core/ and kernels/ is not a solver value
    codes = _codes(sync_safety, src, "src/repro_torch/tune/fixture.py")
    assert "TS2" not in codes, codes


def test_sync_safety_explicit_streams_are_silent():
    src = """
        import numpy as np
        import torch

        def draw(n, g, rng):
            x = torch.randn((n, 2), generator=g)
            y = torch.empty(n).normal_(generator=g)
            z = np.random.default_rng(7).standard_normal(n)
            return x, y, z, rng.integers(0, n)
    """
    assert _codes(sync_safety, src, "src/repro_torch/core/fixture.py") == []


# -- the runner and its baseline ----------------------------------------------

def test_finding_key_has_no_line_number():
    a = Finding("KP1", "src/repro_torch/csrc/x.cu", 10, "k", "m")
    b = Finding("KP1", "src/repro_torch/csrc/x.cu", 99, "k", "m")
    assert a.key == b.key == "KP1:src/repro_torch/csrc/x.cu:k"


def test_baseline_entries_each_carry_a_reason():
    with open(lint.BASELINE_FILE, encoding="utf-8") as f:
        entries = json.load(f)["findings"]
    assert entries and all(len(e["justification"]) > 40 for e in entries)
    assert not any(e["justification"] == lint.UNJUSTIFIED for e in entries)


def test_tree_passes_fail_on_new_against_the_baseline():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                          "--fail-on-new"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert " 0 new," in run.stdout and "stale baseline entry" not in run.stdout


def test_fail_on_new_rejects_an_unbaselined_finding(tmp_path, capsys):
    empty = tmp_path / "baseline.json"
    empty.write_text('{"findings": []}\n')
    assert lint.main(["--fail-on-new", "--baseline", str(empty)]) == 1
    assert "FAIL" in capsys.readouterr().err
    lint.write_baseline(str(empty), lint.run_checkers(ROOT), {})
    assert lint.main(["--fail-on-new", "--baseline", str(empty)]) == 1
    assert "without a justification" in capsys.readouterr().err
    assert lint.main(["--baseline", str(empty)]) == 0


def test_json_mode_lists_the_baselined_findings(capsys):
    assert lint.main(["--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows and all(r["baselined"] for r in rows)
    assert all(r["key"] == f"{r['code']}:{r['path']}:{r['symbol']}"
               for r in rows)


BLOCKED_RUN = """
import importlib.abc, sys, types

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "repro", "jax", "numpy"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
pkg = types.ModuleType("repro_torch")        # the checks, not the port
pkg.__path__ = [sys.argv[1]]
sys.modules["repro_torch"] = pkg
from repro_torch.analysis import lint
rc = lint.main(["--fail-on-new"])
assert not any(m.split(".")[0] in ("torch", "repro") for m in sys.modules)
print("RC", rc)
"""


def test_checks_import_neither_torch_nor_the_reference():
    """The analysis package runs with torch, numpy, jax and ``repro``
    unimportable, and its modules import nothing but the standard library
    and each other."""
    run = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN,
         os.path.join(ROOT, "src", "repro_torch")], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "RC 0" in run.stdout, run.stderr
    here = os.path.dirname(lint.__file__)
    for name in sorted(os.listdir(here)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(here, name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                top = mod.split(".")[0]
                assert top in sys.stdlib_module_names or \
                    mod.startswith("repro_torch.analysis"), (name, mod)


def test_dead_modules_takes_the_paper_and_example_clis_as_roots():
    main = "from repro_torch.paper import common\nif __name__ == '__main__':\n    pass\n"
    files = {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/paper/__init__.py": "",
        "src/repro_torch/paper/common.py": "",
        "src/repro_torch/paper/fig.py": main,
        "src/repro_torch/paper/draft.py": "",
        "src/repro_torch/examples/__init__.py": "",
        "src/repro_torch/examples/demo.py": main,
        "src/repro_torch/examples/unused.py": "",
    }
    found = {s for _c, s in _repo(dead_modules, files)}
    assert found == {"repro_torch.paper.draft",
                     "repro_torch.examples.unused"}, found
