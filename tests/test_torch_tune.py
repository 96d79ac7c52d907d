"""repro_torch's CSR matvec seam and tuning table against the reference:
the segment-sum pair's plain versions against the Pallas kernels
(interpret mode), the variant selection order the reference pins
(tests/test_tune.py, tests/test_sweep_kernels.py), the table's round trip
and ``diff``, the port's own default table file, and the autotuner CLI on
the CPU.

Tolerances: plain segment sums against the Pallas kernels and every
variant against the dense product rtol 1e-5 / atol 1e-5 (different f32
summation orders); the predicated twins, the table-steered and the forced
variants bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CsrOp as RefCsrOp  # noqa: E402
from repro.core import random_sparse_spd as ref_spd  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import spd  # noqa: E402
from repro_torch.core.engine import Schedule, solve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tune import (TuneKey, TuningTable, autotune,  # noqa: E402
                              runtime, shape_bucket, table, use_table)


def _table(*entries) -> TuningTable:
    """A synthetic in-memory table with the given (key, choice) pairs."""
    t = TuningTable(backend="cpu", device_kind="cpu",
                    torch_version=torch.__version__)
    for key, choice in entries:
        t.record(key, choice, {choice: 1.0})
    return t


def _pattern(kind):
    """A dense numpy matrix: the reference's sparse SPD, the same with one
    zeroed 8-row panel and every 3rd row zero (empty panels), or a
    rectangular one with a ragged last panel."""
    A = np.array(ref_spd(96, row_nnz=7, n_rhs=1, seed=13).A)
    if kind == "holes":
        A[8:16] = 0.0
        A[::3] = 0.0
    if kind == "ragged":
        A = A[:53, :40]
    return A


def _ref_and_port(A, storage_dtype=None, rows_per_panel=8):
    r = RefCsrOp.from_dense(jnp.asarray(A), rows_per_panel=rows_per_panel,
                            storage_dtype=storage_dtype)
    p = convert.csr_from_arrays(
        r.data, r.indices, r.row_id, r.row_start, r.row_nnz,
        shape=r.shape, nnz=r.nnz, row_cap=r.row_cap,
        rows_per_panel=r.rows_per_panel, panel_width=r.panel_width,
        device="cpu")
    return r, p


def _x(n, k=3, seed=14):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


@pytest.mark.parametrize("kind,storage,R", [
    ("plain", None, 8), ("holes", None, 8), ("holes", "bfloat16", 8),
    ("ragged", None, 8), ("holes", None, 1)])
def test_segsum_plain_matches_pallas(kind, storage, R):
    A = _pattern(kind)
    r, p = _ref_and_port(A, storage, R)
    x = _x(A.shape[1])
    kw = dict(m=r.shape[0], rows_per_panel=r.rows_per_panel,
              panel_width=r.panel_width)
    want = ref_ops.spmv_csr(r.data, r.indices, r.row_id, jnp.asarray(x),
                            interpret=True, **kw)
    want_skip = ref_ops.spmv_csr_prefetch(
        r.data, r.indices, r.row_id, r.panel_nnz(), jnp.asarray(x),
        interpret=True, **kw)
    xt = torch.from_numpy(x)
    got = ops.spmv_csr(p.data, p.indices, p.row_id, xt, **kw,
                       **p.segsum_rows())
    got_skip = ops.spmv_csr_prefetch(p.data, p.indices, p.row_id,
                                     p.panel_nnz(), xt, **kw,
                                     **p.segsum_rows())
    for g, w in ((got, want), (got_skip, want_skip)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the predicated twin is the plain one, bitwise
    assert torch.equal(got, got_skip)
    if kind == "holes":
        assert bool((p.panel_nnz() == 0).any())


@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_matvec_variants_agree_with_the_dense_product(storage):
    A = _pattern("holes")
    _, p = _ref_and_port(A, storage)
    x = torch.from_numpy(_x(A.shape[1]))
    want = p.to_dense().float() @ x
    outs = {v: p.matvec(x, variant=v) for v in table.MATVEC_VARIANTS}
    for v, y in outs.items():
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5, msg=v)
    assert torch.equal(outs["segsum"], p.matvec_segsum(x))
    assert torch.equal(outs["segsum_prefetch"],
                       p.matvec_segsum(x, skip_empty=True))
    assert torch.equal(outs["sliced"], outs["sliced_prefetch"])


def test_matvec_missing_entry_keeps_the_default_choice_bitwise():
    _, cop = _ref_and_port(_pattern("plain"))
    _, pop = _ref_and_port(_pattern("holes"))
    x = torch.from_numpy(_x(96))
    with use_table(None):
        # dense panels: the plain sliced kernel; empty panels: its twin
        assert torch.equal(cop.matvec(x), cop.matvec(x, skip_empty=False))
        assert torch.equal(pop.matvec(x), pop.matvec(x, skip_empty=True))
    assert not bool((cop.panel_nnz() == 0).any())


def test_matvec_table_entry_steers_to_segsum_bitwise():
    _, cop = _ref_and_port(_pattern("plain"))
    x = torch.from_numpy(_x(96))
    with use_table(_table((runtime.matvec_key(cop), "segsum"))):
        steered = cop.matvec(x)
    np.testing.assert_array_equal(steered.numpy(),
                                  cop.matvec_segsum(x).numpy())


def test_matvec_explicit_variant_beats_contrary_table():
    _, cop = _ref_and_port(_pattern("plain"))
    x = torch.from_numpy(_x(96))
    with use_table(_table((runtime.matvec_key(cop), "segsum"))):
        forced = cop.matvec(x, variant="sliced")
        skipped = cop.matvec(x, skip_empty=False)
    with use_table(None):
        default = cop.matvec(x, skip_empty=False)
    assert torch.equal(forced, default)
    assert torch.equal(skipped, default)


def test_matvec_unknown_variant_raises():
    _, cop = _ref_and_port(_pattern("plain"))
    with pytest.raises(ValueError, match="unknown matvec variant"):
        cop.matvec(torch.zeros((96, 1)), variant="blocked")


def test_tuned_rows_per_panel_is_layout_only_bitwise():
    prob = spd.random_sparse_spd(96, row_nnz=7, n_rhs=2, seed=13,
                                 device="cpu")
    sched = Schedule(num_iters=48, record_every=48)
    picks = torch.from_numpy(np.random.default_rng(7).integers(0, 96, 48))
    t = _table((runtime.panel_key(96), "4"))
    with use_table(t):
        assert runtime.tuned_rows_per_panel(96) == 4
        auto = solve(prob, format="csr", picks=picks, schedule=sched)
    with use_table(None):
        assert runtime.tuned_rows_per_panel(96) is None
        explicit = solve(prob, format="csr", rows_per_panel=4, picks=picks,
                         schedule=sched)
        default = solve(prob, format="csr", picks=picks, schedule=sched)
    assert torch.equal(auto.x, explicit.x) and torch.equal(auto.x, default.x)


def test_shape_bucket_and_keys_match_the_reference():
    from repro.tune import runtime as ref_runtime
    from repro.tune import table as ref_table
    for m in (1, 1000, 1024, 1025):
        assert shape_bucket(m) == ref_table.shape_bucket(m)
    r, p = _ref_and_port(_pattern("holes"), "bfloat16")
    assert runtime.matvec_key(p) == tuple(ref_runtime.matvec_key(r))
    assert runtime.panel_key(96, "bfloat16") == tuple(
        ref_runtime.panel_key(96, "bfloat16"))
    assert table.SCHEMA_VERSION == ref_table.SCHEMA_VERSION
    assert table.MATVEC_VARIANTS == ref_table.MATVEC_VARIANTS


def test_table_round_trip_and_diff(tmp_path):
    key = TuneKey("matvec", "CsrOp", "-", "n1024", "f32")
    t = _table((key, "segsum"), (runtime.panel_key(1024), "16"))
    path = t.save(tmp_path / "a.json")
    back = TuningTable.load(path)
    assert back.choices() == t.choices()
    assert back.lookup(key) == "segsum" and back.torch_version
    assert autotune.main(["diff", str(path), str(path)]) == 0
    other = _table((key, "sliced"))
    other.save(tmp_path / "b.json")
    assert autotune.main(["diff", str(path), str(tmp_path / "b.json")]) == 1
    back.merge(other)                  # the other table wins on its keys
    assert back.lookup(key) == "sliced"
    assert back.lookup(runtime.panel_key(1024)) == "16"
    with pytest.raises(ValueError, match="malformed tune key"):
        TuneKey.parse("matvec/CsrOp")


def test_default_table_is_the_ports_own(monkeypatch, tmp_path):
    """The port reads TUNE_torch_<backend>.json (none is committed) and
    REPRO_TORCH_TUNE_TABLE, never the reference's TUNE_cpu.json."""
    assert table.default_path("cpu").name == "TUNE_torch_cpu.json"
    assert table.default_path("cpu").parent == table.REPO_ROOT
    assert (table.REPO_ROOT / "TUNE_cpu.json").exists()

    def fresh():
        monkeypatch.setattr(runtime, "_active", runtime._UNSET)
        monkeypatch.setattr(runtime, "_default_cache", runtime._UNSET)

    monkeypatch.delenv("REPRO_TORCH_TUNE_TABLE", raising=False)
    monkeypatch.delenv("REPRO_TUNE_TABLE", raising=False)
    fresh()
    assert not table.default_path("cpu").exists()
    assert runtime.active_table() is None
    # the reference's variable steers nothing here
    monkeypatch.setenv("REPRO_TUNE_TABLE", str(table.REPO_ROOT /
                                                 "TUNE_cpu.json"))
    fresh()
    assert runtime.active_table() is None
    path = _table((runtime.panel_key(64), "4")).save(tmp_path / "t.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", str(path))
    fresh()
    assert runtime.tuned_rows_per_panel(64) == 4
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", "off")
    fresh()
    assert runtime.active_table() is None


def test_autotune_sweep_on_the_cpu_writes_only_its_out(tmp_path, capsys):
    out = tmp_path / "tune.json"
    before = sorted(p.name for p in table.REPO_ROOT.iterdir())
    assert autotune.main(["sweep", "--n", "64", "--k", "2", "--repeats", "1",
                          "--device", "cpu", "--out", str(out)]) == 0
    assert sorted(p.name for p in table.REPO_ROOT.iterdir()) == before
    t = TuningTable.load(out)
    assert t.backend == "cpu" and t.device_kind == "cpu"
    choices = t.choices()
    assert choices["matvec/CsrOp/-/n64/f32"] in table.MATVEC_VARIANTS
    assert choices["panel/CsrOp/-/n64/f32"] in ("4", "8", "16")
    assert autotune.main(["show", str(out)]) == 0
    assert "matvec/CsrOp/-/n64/f32" in capsys.readouterr().out
