"""The port stands alone: no file of src/repro_torch, and not chip_smoke.py,
imports JAX or the reference package; and chip_smoke.py refuses to run
(non-zero exit, no result line) without a CUDA device or without the
repository beside it."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", [*PORT_FILES, ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scanner_sees_forbidden_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import spd\n"
                   "import importlib\nimportlib.import_module('jaxlib')\n")
    assert _imported_roots(bad) >= {"jax", "repro", "jaxlib"}
    assert len(PORT_FILES) >= 10


def _run_smoke(cwd: Path):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


ITEM6 = ("theory", "cg_solve", "fcg_solve", "make_rgs_preconditioner",
         "random_lsq", "rk_solve", "async_rk_solve", "async_rgs_solve",
         "rgs_general", "solve_async_sim")


@pytest.mark.parametrize("name", ITEM6)
def test_port_exports_the_simulator_theory_and_baselines(name):
    import repro_torch
    from repro_torch import core
    assert name in repro_torch.__all__ and name in core.__all__
    assert getattr(repro_torch, name) is getattr(core, name)
