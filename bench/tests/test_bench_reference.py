"""The plain reference (``bench/reference``) against a loop of single
steps, and against ``repro_torch.solve_batched`` run on the CPU."""
import pytest
import torch

from bench.problem import packed_layout
from bench.reference import compare, gs
from bench.registry import generator
from bench.tests import tiny  # noqa: F401  (puts src on the path)


def problems():
    return {
        "paper": generator("paper_spd").generate(
            dict(n=128, row_nnz=4, offdiag=0.9, matrix_seed=5), "cpu"),
        "hpcg": generator("hpcg_27pt").generate(dict(nx=8, ny=4, nz=4), "cpu"),
    }


@pytest.mark.parametrize("name", ["paper", "hpcg"])
@pytest.mark.parametrize("block", [1, 4])
def test_grouped_replay_is_the_loop(name, block):
    p = problems()[name]
    A = gs.Matrix(p.indptr, p.indices, p.data)
    g = torch.Generator().manual_seed(7)
    picks = torch.randint(0, p.n // block, (3 * p.n // block,), generator=g)
    b = torch.randn(p.n, 2, generator=g)
    x0 = torch.randn(p.n, 2, generator=g, dtype=torch.float64)
    want = gs.sweep_loop(A, b, x0, picks, block=block)
    got = gs.sweep(A, b, x0, picks, block=block)
    assert torch.allclose(got, want, rtol=0, atol=1e-13)
    # the groups are real groups: far fewer than the picks
    assert len(gs.group_starts(A, picks, block)) < picks.numel()


def program_units(p, block, k, rtol, sweeps, seed):
    """Two solves of the program on the CPU, as the harness hands them to
    the comparison."""
    from repro_torch import solve_batched
    from repro_torch.convert import csr_from_arrays

    op = csr_from_arrays(**packed_layout(p, 8), device="cpu")
    per = p.n // block
    units = []
    for s in range(2):
        g = torch.Generator().manual_seed(seed + s)
        b = torch.randn(p.n, k, generator=g) if p.b is None else p.b
        picks = torch.randint(0, per, (sweeps * per,), generator=g,
                              dtype=torch.int32)
        tol = rtol * torch.linalg.vector_norm(b, dim=0)
        res = solve_batched(op, b, action="gs", num_iters=sweeps * per,
                            tol=tol, picks=picks, record_every=per,
                            block=block)
        units.append(compare.Unit(
            b=b, tol=tol, picks=picks[:res.iters_run],
            x_in=torch.zeros_like(res.x), x=res.x, resid=res.resid,
            rounds=res.rounds, converged=res.converged,
            iters_run=res.iters_run, per_record=per, cap_records=sweeps,
            block=block))
    return units


@pytest.mark.parametrize("name, block, k, rtol", [
    ("paper", 1, 3, 1e-3), ("paper", 8, 3, 1e-3),
    ("hpcg", 1, 1, 1e-2), ("hpcg", 4, 1, 1e-2)])
def test_reference_agrees_with_the_program(name, block, k, rtol):
    p = problems()[name]
    if p.b is not None and k != p.b.shape[1]:
        pytest.skip("the configuration's b has one column")
    A = gs.Matrix(p.indptr, p.indices, p.data)
    units = program_units(p, block, k, rtol, sweeps=64, seed=11)
    r = compare.check(A, units, band=1e-4)
    assert r.units == 2
    assert r.x_err < 1e-5 and r.record_err < 1e-4 and r.exit_mismatch == 0
    # every solve stopped early, at the reference's record
    assert all(u.iters_run < 64 * u.per_record for u in units)
    assert all(bool(u.converged.all()) for u in units)


def test_reference_rejects_a_perturbed_x():
    p = problems()["paper"]
    A = gs.Matrix(p.indptr, p.indices, p.data)
    units = program_units(p, 1, 3, 1e-3, sweeps=64, seed=3)
    units[1].x = units[1].x.clone()
    units[1].x[5, 1] += 1e-2
    r = compare.check(A, units, band=1e-4)
    ok, table = compare.verdict(r, {"x_err": 1e-4, "record_err": 1e-4,
                                    "exit_mismatch": 0})
    assert not ok and table["x_err"]["value"] > 1e-4


def test_reference_rejects_a_wrong_exit():
    p = problems()["paper"]
    A = gs.Matrix(p.indptr, p.indices, p.data)
    units = program_units(p, 1, 3, 1e-3, sweeps=64, seed=4)
    u = units[0]
    # claim the last column met its tolerance a record earlier
    u.rounds = u.rounds.clone()
    c = int(torch.argmax(u.rounds))
    u.rounds[c] -= 1
    r = compare.check(A, [u], band=1e-4)
    assert r.exit_mismatch >= 1


def test_nan_reads_as_the_worst():
    r = compare.Readings(x_err=float("nan"), units=1)
    ok, _ = compare.verdict(r, {"x_err": 1.0, "record_err": 1.0,
                                "exit_mismatch": 0})
    assert not ok
