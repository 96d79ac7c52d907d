"""What the benchmark runs loads neither JAX nor the JAX package, and reads
none of the JAX package's benchmark files."""
import json
import subprocess
import sys

from bench.registry import ROOT

SCRIPT = r"""
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:] = [str(root), str(root / "src")] + sys.path[1:]
import importlib
from bench import registry
for path in sorted((root / "bench").rglob("*.py")):
    rel = path.relative_to(root)
    if "tests" in rel.parts:
        continue
    if rel.parts[1] in ("generators", "metrics"):
        registry._module(path)
    else:
        importlib.import_module(".".join(rel.with_suffix("").parts))
import repro_torch  # the program the harness drives
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bench" in top and "repro_torch" in top
    # compared whole: repro_torch begins with repro
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_no_file_of_the_benchmark_names_the_jax_packages_benchmarks():
    for path in (ROOT / "bench").rglob("*"):
        if path.suffix not in (".py", ".json") or "tests" in path.parts:
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path
        assert "import jax" not in text and "from repro " not in text, path
        assert "import repro\n" not in text and "from repro." not in text, path
