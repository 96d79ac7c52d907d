"""repro_torch's slab assignment (``core/partition.py``) and the operator
queries it leans on against the reference's ``repro.core.partition``.

Same inputs, same answers, exactly: the greedy bin-packing's labels and
the permutation on the same ``row_norms_sq`` / nonzero counts, the
permuted operators' layouts (CSR through ``_assemble``, ELL by its
windows) array for array, the diagnostics (``cross_slab_edges``,
``slab_norm_mass``), ``nnz_cost`` on every format and ``CsrOp.row_reach``.
The validation errors carry the reference's messages.  The norm-mass
bound is the reference's: within 2x of uniform per slab.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import as_operator as ref_as_operator  # noqa: E402
from repro.core import partition as ref_pt  # noqa: E402
from repro.core import random_sparse_lsq as ref_lsq  # noqa: E402
from repro.core import spd as ref_spd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import partition as pt  # noqa: E402
from repro_torch.core.distributed import solve_distributed  # noqa: E402
from repro_torch.core.engine import Schedule  # noqa: E402
from repro_torch.core.operators import DenseOp, as_operator  # noqa: E402
from repro_torch.launch.mesh import process_group  # noqa: E402


@pytest.fixture(scope="module")
def skewed():
    """A sparse rectangular design whose first quarter of rows carries
    ~99% of the norm mass (the reference's test design)."""
    A = np.array(ref_lsq(128, 32, row_nnz=6, n_rhs=2, seed=0).A)
    A[:32] *= 20.0
    return A


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with process_group("gloo", tmp_path_factory.mktemp("pg")) as g:
        yield g


def _t(a):
    return convert._tensor(np.asarray(a), "cpu")


def _square():
    return np.asarray(ref_spd.random_sparse_spd(64, row_nnz=6, n_rhs=1,
                                                seed=1).A)


@pytest.mark.parametrize("slabs", [1, 2, 4, 8])
def test_assignment_and_permutation_equal_reference(skewed, slabs):
    op = ref_as_operator(jnp.asarray(skewed), "csr")
    rn = np.asarray(op.row_norms_sq())
    nnz = np.asarray(op.row_nnz)
    labels = pt.norm_balanced_assignment(rn, nnz, slabs)
    np.testing.assert_array_equal(
        labels, ref_pt.norm_balanced_assignment(rn, nnz, slabs))
    rp = pt.partition_permutation(labels, slabs)
    want = ref_pt.partition_permutation(labels, slabs)
    assert rp.perm.dtype == rp.inv.dtype == torch.int64
    np.testing.assert_array_equal(rp.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(rp.inv.numpy(), np.asarray(want.inv))
    # equal bin sizes; the norm mass within 2x of uniform
    assert (np.bincount(labels, minlength=slabs) == 128 // slabs).all()
    mass = pt.slab_norm_mass(rn, rp.perm, slabs)
    np.testing.assert_array_equal(
        mass, ref_pt.slab_norm_mass(rn, np.asarray(want.perm), slabs))
    assert mass.max() <= 2 * rn.astype(np.float64).sum() / slabs


def test_ties_break_as_the_reference(skewed):
    """Equal norms everywhere: the nonzero counts, then the bin index,
    decide."""
    rn = np.ones(96, np.float32)
    nnz = np.random.default_rng(2).integers(1, 9, 96)
    np.testing.assert_array_equal(
        pt.norm_balanced_assignment(rn, nnz, 4),
        ref_pt.norm_balanced_assignment(rn, nnz, 4))


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_balanced_row_permutation_equal_reference(skewed, fmt):
    """From the operators themselves: the port reads its row norms and
    counts back in one read and lands on the reference's permutation,
    on the operator's device."""
    kw = dict(width=8) if fmt == "ell" else {}
    A = skewed if fmt == "csr" else _square()
    op = as_operator(_t(A), fmt, **kw)
    rp = pt.balanced_row_permutation(op, 4)
    want = ref_pt.balanced_row_permutation(
        ref_as_operator(jnp.asarray(A), fmt, **kw), 4)
    assert rp.perm.device == op.device
    np.testing.assert_array_equal(rp.perm.numpy(), np.asarray(want.perm))
    labels = pt.balanced_labels(op, 4)
    assert pt.cross_slab_edges(op, labels, 4) == ref_pt.cross_slab_edges(
        ref_as_operator(jnp.asarray(A), fmt, **kw), labels, 4)


CASES = [("csr", False), ("csr", True), ("ell", True), ("ell", False)]


@pytest.mark.parametrize("fmt,symmetric", CASES,
                         ids=[f"{f}-{'sym' if s else 'rows'}"
                              for f, s in CASES])
def test_permute_rows_layout_equal_reference(skewed, fmt, symmetric):
    A = _square() if symmetric or fmt == "ell" else skewed
    kw = dict(width=32) if fmt == "ell" else {}       # every entry kept
    ref_op = ref_as_operator(jnp.asarray(A), fmt, **kw)
    rp_ref = ref_pt.balanced_row_permutation(ref_op, 4)
    got = pt.permute_rows(as_operator(_t(A), fmt, **kw),
                          pt.partition_permutation(
                              np.asarray(ref_pt.balanced_labels(ref_op, 4)),
                              4), symmetric=symmetric)
    want = ref_pt.permute_rows(ref_op, rp_ref, symmetric=symmetric)
    assert type(got).__name__ == type(want).__name__
    fields = (("data", "indices", "row_id", "row_start", "row_nnz")
              if fmt == "csr" else ("vals", "cols"))
    for f in fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    if fmt == "csr":
        for f in ("nnz", "row_cap", "rows_per_panel", "panel_width"):
            assert getattr(got, f) == getattr(want, f), f
    perm = np.asarray(rp_ref.perm)
    dense = A[perm][:, perm] if symmetric else A[perm]
    np.testing.assert_array_equal(got.to_dense().numpy(), dense)


def test_apply_partition_moves_what_the_action_needs(skewed):
    op = as_operator(_t(skewed), "csr")
    b = torch.arange(256, dtype=torch.float32).view(128, 2)
    x0 = torch.zeros((32, 2))
    op2, b2, x2, xs2, rp = pt.apply_partition(op, b, x0, None, action="rk",
                                              num_slabs=4)
    assert torch.equal(b2, b[rp.perm]) and x2 is x0 and xs2 is None
    sq = as_operator(_t(_square()), "ell", width=12)
    v = torch.arange(128, dtype=torch.float32).view(64, 2)
    op3, _, x3, xs3, rp3 = pt.apply_partition(sq, v, v, v, action="gs",
                                              num_slabs=4)
    assert torch.equal(x3, v[rp3.perm]) and torch.equal(xs3, v[rp3.perm])
    assert torch.equal(x3[rp3.inv], v)


def test_validation_errors_as_reference(skewed, group):
    op = as_operator(_t(skewed), "csr")
    rp = pt.balanced_row_permutation(op, 4)
    with pytest.raises(ValueError, match="square"):
        pt.permute_rows(op, rp, symmetric=True)
    for bad in (DenseOp(_t(skewed)),
                as_operator(_t(_square()), "banded", block=16, bands=1)):
        with pytest.raises(NotImplementedError, match="padded-row"):
            pt.balanced_row_permutation(bad, 4)
        with pytest.raises(NotImplementedError, match="padded-row"):
            pt.permute_rows(bad, rp)
        with pytest.raises(NotImplementedError, match="padded-row"):
            pt.cross_slab_edges(bad, np.zeros(128, np.int32), 4)
    rn = np.ones(126)
    with pytest.raises(ValueError, match="divide"):
        pt.norm_balanced_assignment(rn, rn, 4)
    with pytest.raises(ValueError, match="assign every row"):
        pt.cross_slab_edges(op, np.zeros(5, np.int32), 4)
    with pytest.raises(ValueError, match="unknown partition"):
        Schedule(rounds=2, local_steps=4, partition="graph").validate()
    with pytest.raises(ValueError, match="distributed-schedule"):
        Schedule(num_iters=64, partition="balanced").validate()
    sched = Schedule(rounds=2, local_steps=4, partition="balanced")
    assert sched.validate() == sched
    # the engine: dense and banded formats raise the reference's message
    sq = _t(_square())
    for bad in (DenseOp(sq), as_operator(sq, "banded", block=16, bands=1)):
        with pytest.raises(NotImplementedError, match="padded-row"):
            solve_distributed(bad, sq[:, :2].contiguous(),
                              torch.zeros((64, 2)), None, action="gs",
                              group=group, rounds=2, local_steps=4, seed=0,
                              partition="balanced")
    with pytest.raises(ValueError, match="unknown partition"):
        solve_distributed(as_operator(sq, "csr"), sq[:, :2].contiguous(),
                          torch.zeros((64, 2)), None, action="gs",
                          group=group, rounds=2, local_steps=4, seed=0,
                          partition="graph")


FORMATS = [("dense", {}), ("banded", dict(block=16, bands=1)),
           ("ell", dict(width=12)), ("csr", {})]


@pytest.mark.parametrize("fmt,kw", FORMATS, ids=[f for f, _ in FORMATS])
def test_nnz_cost_equal_reference(fmt, kw):
    A = np.asarray(ref_spd.block_banded_spd(64, block=16, bands=1,
                                            seed=3).A)
    assert (as_operator(_t(A), fmt, **kw).nnz_cost()
            == ref_as_operator(jnp.asarray(A), fmt, **kw).nnz_cost())


@pytest.mark.parametrize("A", ["square", "banded", "empty-rows"])
def test_row_reach_equal_reference(A):
    if A == "square":
        M = _square()
    elif A == "banded":
        M = np.asarray(ref_spd.block_banded_spd(64, block=8, bands=2,
                                                seed=4).A)
    else:
        M = _square().copy()
        M[::5] = 0.0
    got = as_operator(_t(M), "csr").row_reach()
    want = np.asarray(ref_as_operator(jnp.asarray(M), "csr").row_reach())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt,seed", [("csr", 0), ("csr", 1), ("ell", 0),
                                      ("ell", 2)])
def test_row_norms_bitwise_reference_and_near_ties(fmt, seed):
    """CSR and ELL row norms add each row's squares left to right, as the
    reference's sums do on the CPU: bitwise equal, so a design whose rows
    nearly tie in norm still gets the reference's balanced permutation
    (a last-bit difference would reorder the greedy's rows)."""
    A = np.asarray(ref_spd.random_sparse_spd(256, row_nnz=8, seed=seed).A)
    kw = dict(width=12) if fmt == "ell" else {}
    op = as_operator(_t(A), fmt, **kw)
    ref_op = ref_as_operator(jnp.asarray(A), fmt, **kw)
    np.testing.assert_array_equal(op.row_norms_sq().numpy(),
                                  np.asarray(ref_op.row_norms_sq()))
    assert op.row_norms_sq() is op.row_norms_sq()          # computed once
    np.testing.assert_array_equal(
        pt.balanced_row_permutation(op, 4).perm.numpy(),
        np.asarray(ref_pt.balanced_row_permutation(ref_op, 4).perm))
