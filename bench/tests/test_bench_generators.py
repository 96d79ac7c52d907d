"""The configurations' generators at small sizes on the CPU."""
import numpy as np
import pytest
import torch

from bench.problem import Problem, packed_layout
from bench.registry import ROOT, generator
from bench.tests import tiny  # noqa: F401  (puts src on the path)


def dense(p: Problem) -> torch.Tensor:
    rows = torch.repeat_interleave(torch.arange(p.n), p.row_nnz())
    out = torch.zeros((p.n, p.n), dtype=torch.float64)
    out[rows, p.indices] = p.data.double()
    return out


def hpcg(nx, ny, nz):
    return generator("hpcg_27pt").generate(dict(nx=nx, ny=ny, nz=nz), "cpu")


def paper(n=512, row_nnz=8, seed=0):
    return generator("paper_spd").generate(
        dict(n=n, row_nnz=row_nnz, offdiag=0.9, matrix_seed=seed), "cpu")


@pytest.mark.parametrize("nx, ny, nz", [(4, 4, 4), (5, 4, 3)])
def test_hpcg_stencil(nx, ny, nz):
    p = hpcg(nx, ny, nz)
    assert p.n == nx * ny * nz
    assert p.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    A = dense(p)
    assert torch.equal(A, A.T)
    assert torch.equal(A.diagonal(), torch.ones(p.n, dtype=torch.float64))
    assert set(A[A != 0].unique().tolist()) == {1.0, float(np.float32(-1 / 26))}
    # b = A 1, the configuration's values rounded once
    want = (27 - p.row_nnz()).double() / 26
    assert torch.allclose(A.sum(1), want, rtol=0, atol=1e-6)
    assert torch.equal(p.b[:, 0], want.float())


def test_paper_problem_is_symmetric_with_gershgorin_lambda_min():
    p = paper()
    A = dense(p)
    assert torch.equal(A, A.T)
    assert torch.equal(A.diagonal(), torch.ones(p.n, dtype=torch.float64))
    off = (A - torch.eye(p.n, dtype=torch.float64)).abs().sum(1)
    assert 1 - off.max() >= 0.1 - 1e-6
    assert torch.linalg.eigvalsh(A).min() >= 0.1 - 1e-6
    # 8 random columns a row before symmetrising, so 9 to 17 stored
    assert p.row_nnz().min() >= 2 and p.nnz > 8 * p.n


@pytest.mark.parametrize("make", [lambda: hpcg(5, 4, 3), lambda: paper(256, 4)])
def test_rows_sorted_with_their_diagonal(make):
    p = make()
    rows = torch.repeat_interleave(torch.arange(p.n), p.row_nnz())
    key = rows * p.n + p.indices
    assert bool((key[1:] > key[:-1]).all())
    assert int((p.indices == rows).sum()) == p.n


@pytest.mark.parametrize("make", [lambda: hpcg(5, 4, 3), lambda: paper(256, 4)])
@pytest.mark.parametrize("rows_per_panel", [8, 3])
def test_packed_layout_accepted_by_the_program(make, rows_per_panel):
    from repro_torch.convert import csr_from_arrays

    p = make()
    op = csr_from_arrays(**packed_layout(p, rows_per_panel), device="cpu")
    A = dense(p)
    assert torch.equal(op.to_dense().double(), A)
    x = torch.randn(p.n, 3, dtype=torch.float64)
    assert torch.allclose(op.matvec(x.float()).double(), A @ x, atol=1e-5)


@pytest.mark.parametrize("make", [lambda s: hpcg(5, 4, 3),
                                  lambda s: paper(256, 4, seed=s)])
def test_same_seed_same_arrays(make):
    a, b = make(3), make(3)
    for name in ("indptr", "indices", "data"):
        assert torch.equal(getattr(a, name), getattr(b, name))


def test_matrix_seed_changes_the_paper_problem():
    assert not torch.equal(paper(256, 4, 1).data, paper(256, 4, 2).data)


def test_configuration_files_hold_what_is_run():
    import json

    for name in ("paper-spd-16k", "hpcg-27pt-104"):
        cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
        assert cfg["name"] == name and cfg["dtype"] == "float32"
    cfg = json.loads((ROOT / "bench" / "configs" / "hpcg-27pt-104.json").read_text())
    assert (cfg["nx"], cfg["ny"], cfg["nz"]) == (104, 104, 104)
