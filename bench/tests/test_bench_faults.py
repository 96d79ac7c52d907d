"""A whole run on the CPU at a small size, with the timed path sound, with
the control in the program's place, and with it broken underneath: each
fault a cell can have must make ``correct`` false.  (The harness's look
for a card is in ``run.py``; ``run_cell`` runs on the device it is given.)

Faults: a sweep that returns its state unchanged; half of the batch left
out (half the right-hand-side columns, or with one column half of the
picks); an answer altered where it is produced (one entry of the iterate a
sweep returns).  A cell on one card has no exchange between cards to leave
out."""
import subprocess
import sys

import pytest
import torch

from bench import controls, harness
from bench.registry import ROOT
from bench.tests.tiny import make_root

CELLS = ["spd16k-gs-solve", "hpcg104-gs-sweep", "spd16k-bgs128-solve",
         "hpcg104-bgs8-sweep"]


def unchanged(real):
    def sweep(op, b, x, picks, **kw):
        return x
    return sweep


def half_left_out(real):
    def sweep(op, b, x, picks, **kw):
        k = x.shape[1]
        if k == 1:
            return real(op, b, x, picks[:picks.numel() // 2].contiguous(), **kw)
        out = x.clone()
        h = k // 2
        out[:, :h] = real(op, b[:, :h].contiguous(), x[:, :h].contiguous(),
                          picks, **kw)
        return out
    return sweep


def altered(real):
    def sweep(op, b, x, picks, **kw):
        out = real(op, b, x, picks, **kw).clone()
        out[0, 0] += 0.05
        return out
    return sweep


def run(root, cell):
    return harness.run_cell(cell, 2 ** 31 + 11, 0.01, False, root=root,
                            device="cpu", log=lambda _: None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    r = run(root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell, monkeypatch):
    import repro_torch.convert as convert

    real = convert.csr_from_arrays
    monkeypatch.setattr(convert, "csr_from_arrays",
                        lambda *a, **kw: controls.bf16(real(*a, **kw)))
    r = run(root, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(root, cell, fault, monkeypatch):
    from repro_torch.core import engine

    monkeypatch.setattr(engine, "sweep", fault(engine.sweep))
    r = run(root, cell)
    assert not r["correct"], r["checks"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py runs the cell")
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                          "--workload", "spd16k-gs-solve", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr
