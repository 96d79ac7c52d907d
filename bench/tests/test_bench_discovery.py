"""A configuration, a cell and a per-layer metric added as new files and
``BENCHMARK.json`` entries, with no edit of a file the harness has."""
import json

from bench import harness
from bench.tests.tiny import make_root

READER = '''"""records_total: every record the window's units ran."""


def read(run):
    return float(sum(u.records for u in run.units))
'''


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    d = root / "bench"
    cfg = json.loads((d / "configs" / "hpcg-27pt-104.json").read_text())
    cfg.update(name="hpcg-27pt-6", nx=6, ny=6, nz=6)
    (d / "configs" / "hpcg-27pt-6.json").write_text(json.dumps(cfg))
    (d / "cells" / "hpcg6-gs-sweep.json").write_text(
        (d / "cells" / "hpcg104-gs-sweep.json").read_text())
    (d / "metrics" / "records_total.py").write_text(READER)
    bm = json.loads((root / "BENCHMARK.json").read_text())
    bm["configs"].append(dict(bm["configs"][1], name="hpcg-27pt-6",
                              file="bench/configs/hpcg-27pt-6.json"))
    bm["workloads"].append(dict(bm["workloads"][1], name="hpcg6-gs-sweep",
                                config="hpcg-27pt-6"))
    for m in bm["end_to_end"]:
        if m["name"] == "sweep_ms":
            m["workloads"].append("hpcg6-gs-sweep")
    bm["per_layer"].append(dict(name="records_total", unit="records",
                                better="higher", source="program_counter",
                                layer="engine", moves="sweep_ms",
                                workloads=["hpcg6-gs-sweep"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bm))

    plain = harness.run_cell("hpcg6-gs-sweep", 5, 0.05, False, root=root,
                             device="cpu", log=lambda _: None)
    assert plain["correct"] and plain["attempted"] >= 1
    assert set(plain["metrics"]) == {"sweep_ms", "setup_s"}
    traced = harness.run_cell("hpcg6-gs-sweep", 6, 0.05, True, root=root,
                              device="cpu", log=lambda _: None)
    assert traced["correct"]
    assert set(traced["metrics"]) == {"records_total"}
    assert traced["metrics"]["records_total"]["value"] == traced["attempted"]
    assert list(traced)[-1] == "checks"
