"""The port's CLIs (``python -m repro_torch.launch.solve`` and
``...launch.lsq``) on the CPU at small sizes: every pass's line is
printed (``launch.solve``'s distributed pass in this process at one
worker, in spawned gloo ranks above), residuals are finite and below
their start, beta~ and the rate factors lie in (0, 1]; both default to the
card and raise without one; ``launch.serve`` takes its ``--format``
choices from ``launch.solve``.
"""
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import lsq, serve, solve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NUM = r"(-?[0-9.]+(?:e[-+][0-9]+)?)"


def _line(text, prefix):
    lines = [ln for ln in text.splitlines() if ln.strip().startswith(prefix)]
    assert len(lines) == 1, (prefix, text)
    return lines[0]


def _number(line, pattern):
    m = re.search(pattern + NUM, line)
    assert m, (pattern, line)
    return float(m.group(1))


@pytest.mark.parametrize("fmt", ["dense", "csr", "ell"])
def test_solve_cli(capsys, fmt):
    out = solve.main(["--device", "cpu", "--n", "128", "--rhs", "3",
                      "--sweeps", "4", "--format", fmt, "--ell-width", "4"])
    text = capsys.readouterr().out
    assert _line(text, "[solve]").endswith(f"format={fmt}")
    b0 = float(torch.linalg.vector_norm(out["problem"].b[:, 0]))
    for prefix in ("sync RGS", "CG"):
        r = _number(_line(text, prefix), r"resid ")
        assert 0 <= r < b0
    theory = _line(text, "theory")
    assert 0 < _number(theory, r"beta~=") <= 1
    assert 0 < _number(theory, r"epoch factor <= ") <= 1
    assert _number(theory, r"tau=") == 0 == out["tau"]   # P = 1 on the CPU
    assert ("[warn] --ell-width 4" in text) == (fmt == "ell")
    # the distributed pass at P = 1 (one worker on the CPU), in process
    line = _line(text, "async RGS")
    assert "P=1 tau=0 " in line and "sync=auto (0 B/round) 4 rounds" in line
    assert 0 <= _number(line, r"resid ") < b0
    assert out["async"].resid.shape == (4, 3)
    res = out["sync"]
    assert res.resid.shape == (4, 3) and bool(torch.isfinite(res.resid).all())
    assert bool((res.resid[1:] <= res.resid[:-1]).all())


def test_solve_cli_theory_follows_workers(capsys):
    out = solve.main(["--device", "cpu", "--n", "128", "--rhs", "1",
                      "--sweeps", "1", "--workers", "4", "--local-steps",
                      "8"])
    text = capsys.readouterr().out
    theory = _line(text, "theory")
    assert out["tau"] == 24 and "P=4 tau=24" in theory
    assert 0 < out["beta"] < 1
    # the distributed pass on four spawned gloo ranks: dense_gs under the
    # all-gather, 4 rounds of 8 steps a rank, a 32-row slab of one column
    line = _line(text, "async RGS")
    assert "P=4 tau=24 " in line and "(128 B/round) 4 rounds" in line
    assert out["async"].tau == 24 and out["async"].resid.shape == (4, 1)
    assert 0 <= _number(line, r"resid ") < float(
        torch.linalg.vector_norm(out["problem"].b))


def test_solve_cli_distributed_a2a_and_sync_choices(capsys):
    """Two ranks on CSR under the neighbor exchange; a2a on the dense
    format and halo (the banded format's) are refused as flags."""
    out = solve.main(["--device", "cpu", "--n", "64", "--rhs", "2",
                      "--sweeps", "2", "--format", "csr", "--workers", "2",
                      "--sync", "a2a"])
    line = _line(capsys.readouterr().out, "async RGS")
    assert "P=2 tau=32 " in line and "sync=a2a" in line
    assert out["async"].x.shape == (64, 2)
    assert bool(torch.isfinite(out["async"].resid).all())
    for argv in (["--sync", "a2a"], ["--sync", "halo", "--format", "csr"]):
        with pytest.raises(SystemExit):
            solve.main(["--device", "cpu", "--n", "32", *argv])


@pytest.mark.parametrize("fmt", ["dense", "csr"])
def test_lsq_cli(capsys, fmt):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = lsq.main(["--device", "cpu", "--m", "256", "--n", "32",
                        "--rhs", "2", "--sweeps", "2", "--tau", "8",
                        "--format", fmt])
    text = capsys.readouterr().out
    # the async pass densifies a CSR operator exactly, and says so
    assert any("densifies CsrOp exactly" in str(w.message)
               for w in caught) == (fmt == "csr")
    assert "optimum relresid=" in _line(text, "[lsq]")
    for prefix in ("seq RK", "async RK", "CG (A^T A)"):
        r = _number(_line(text, prefix), r"relresid ")
        assert 0 <= r < 1
    assert 0 < _number(_line(text, "async RK"), r"beta~=") <= 1
    theory = _line(text, "theory")
    assert 0 < _number(theory, r"sync=") <= 1
    assert 0 < _number(theory, r"async\(tau=8\)=") <= 1
    assert out["async"].resid.shape == (2, 2)


def test_lsq_cli_distributed_dense_four_ranks(capsys):
    """The distributed pass at its defaults (dense: dense_rk, one global
    stream) on four spawned gloo ranks; its residual finite and below the
    start."""
    out = lsq.main(["--device", "cpu", "--m", "256", "--n", "32", "--rhs",
                    "2", "--sweeps", "2", "--tau", "8", "--workers", "4"])
    line = _line(capsys.readouterr().out, "par RK")
    assert "P=4 tau=63 " in line and "sampling=global-stream" in line
    assert "(256 B/round) 8 rounds" in line
    assert 0 <= _number(line, r"relresid ") < 1
    par = out["par"]
    assert par.resid.shape == (8, 2) and par.tau == 63 and par.lag is None
    assert bool(torch.isfinite(par.resid).all())
    assert bool((par.resid[-1] < par.resid[0]).all())


def test_lsq_cli_distributed_csr_every_flag(capsys):
    """csr on four ranks with a2a, overlap, the int8 wire and the balanced
    partition: the compressed a2a falls back to the psum (the reference's
    warning), the staleness line is printed, the residual falls."""
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        out = lsq.main(["--device", "cpu", "--m", "256", "--n", "32",
                        "--rhs", "2", "--sweeps", "2", "--tau", "8",
                        "--format", "csr", "--workers", "4", "--rk-sync",
                        "a2a", "--overlap", "--compress", "int8_ef",
                        "--partition", "balanced"])
    text = capsys.readouterr().out
    line = _line(text, "par RK")
    assert "P=4 tau=447 " in line and "sampling=local" in line
    assert ("sync=a2a partition=balanced overlap=True compress=int8_ef "
            "(260 B/round) 2 rounds") in line
    stale = _line(text, "staleness")
    assert "measured lag max=192 (round 1: 0)" in stale
    assert "empirical tau 447 <= scheduled bound 447" in stale
    par = out["par"]
    assert par.lag.tolist() == [0, 192]
    assert bool(torch.isfinite(par.resid).all())
    assert bool((par.resid[-1] < par.resid[0]).all())
    for argv in (["--rk-sync", "a2a"], ["--partition", "balanced"],
                 ["--compress", "bf16"]):
        with pytest.raises(SystemExit):
            lsq.main(["--device", "cpu", "--m", "32", "--n", "8", *argv])


def test_solve_cli_balanced_overlap(capsys):
    """launch.solve's distributed pass on two ranks, CSR, with the balanced
    partition and the overlapped sync: the staleness line, the lag, and
    the iterate of the original (un-permuted) system."""
    out = solve.main(["--device", "cpu", "--n", "64", "--rhs", "2",
                      "--sweeps", "3", "--format", "csr", "--workers", "2",
                      "--partition", "balanced", "--overlap"])
    text = capsys.readouterr().out
    line = _line(text, "async RGS")
    assert "P=2 tau=64 " in line
    assert line.endswith("partition=balanced overlap=True compress=none")
    assert "empirical tau 64 <= scheduled bound 64" in _line(text,
                                                             "staleness")
    res, prob = out["async"], out["problem"]
    assert res.lag.tolist() == [0] + [32] * 2
    # x comes back in the original row order: its residual in the
    # original system is the last record's to within the one round of
    # staleness the record's replica carries (a permuted x would miss by
    # the size of b)
    r = torch.linalg.vector_norm(prob.b - prob.A @ res.x, dim=0)
    assert torch.allclose(r, res.resid[-1], rtol=5e-2)
    assert bool((res.resid[-1] < res.resid[0]).all())
    with pytest.raises(SystemExit):
        solve.main(["--device", "cpu", "--n", "32", "--partition",
                    "balanced"])


@pytest.mark.parametrize("module,argv", [
    ("repro_torch.launch.solve", ["--n", "64", "--rhs", "2", "--sweeps", "2",
                                  "--format", "csr"]),
    ("repro_torch.launch.lsq", ["--m", "128", "--n", "16", "--rhs", "2",
                                "--sweeps", "1", "--tau", "4"])])
def test_cli_as_module(module, argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", module, *argv, "--device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "theory" in out.stdout and "nan" not in out.stdout


@pytest.mark.parametrize("cli,argv", [
    (solve, ["--n", "32", "--sweeps", "1"]),
    (lsq, ["--m", "32", "--n", "8", "--sweeps", "1"])])
def test_clis_default_to_the_card(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(argv)


def test_serve_takes_format_choices_from_solve():
    assert serve.FORMAT_CHOICES is solve.FORMAT_CHOICES
    assert solve.FORMAT_CHOICES == ("dense", "ell", "csr")
    with pytest.raises(SystemExit):
        serve.main(["--format", "banded", "--device", "cpu"])
