"""repro_torch.roofline: the port's kernel bounds on one card.

* ``ring_wire_bytes`` equals the wire bytes the reference's
  ``repro.roofline.collective_bytes`` reports for one synthetic HLO line of
  each collective at group sizes 1, 2, 4 and 8, exactly.
* The bounds of PERF.md §6 come out of the work functions at the main
  path's closed-form shapes (f32 values, int32 indices, k = 51), to the
  digits printed there.
* On small operators each work function equals the inline formula
  ``chip_smoke.py`` used for its kernel before the module existed, written
  out here.
* bf16 values and int16 indices count 2 bytes each; a card without
  published peaks raises.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.roofline import collective_bytes, shape_bytes  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.core.operators import as_operator  # noqa: E402
from repro_torch.core.spd import (block_banded_spd,  # noqa: E402
                                  random_sparse_spd)
from repro_torch.kernels.ref import band_valid  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
K = 51
N, NNZ = 16384, 540360          # random_sparse_spd(16384, row_nnz=16)
HBM, F32_RATE = 3.35e12, 67e12


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", roofline.RING_KINDS)
def test_ring_wire_bytes_is_the_reference_ring_model(kind, group):
    out = "f32[256,51]{1,0}"
    ids = ",".join(str(i) for i in range(group))
    line = (f"  %c = {out} {kind}(f32[256,51]{{1,0}} %p), "
            f"replica_groups={{{{{ids}}}}}")
    want = collective_bytes(line).wire_bytes
    assert roofline.ring_wire_bytes(kind, shape_bytes(out), group) == want


def test_ring_wire_bytes_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective"):
        roofline.ring_wire_bytes("broadcast", 1024, 4)


def _ms(work):
    return roofline.bound_ms(work, H100)


@pytest.mark.parametrize("name,work,printed,by", [
    ("spmv_csr_sliced", roofline.spmv_csr_sliced(NNZ, N, N, K, counts=True),
     "0.00331", "bytes"),
    ("spmv_ell", roofline.spmv_ell(NNZ, N, N, K, counts=True),
     "0.00331", "bytes"),
    ("spmv_csr", roofline.spmv_csr(NNZ, N, N, K), "0.00332", "bytes"),
    ("bbmv", roofline.bbmv(634, 128, N, K), "0.01581", "operations"),
    ("banded_gs_sweep",
     roofline.banded_gs_sweep(128, 128, 2, N + 2 * 2 * 128, K),
     "0.01596", "operations"),
    ("block_gs_sweep", roofline.block_gs_sweep(128, 128, N, K),
     "0.40870", "operations"),
    ("colsum", roofline.colsum(N, K), "0.00100", "bytes"),
])
def test_perf_table_bounds_from_closed_form_shapes(name, work, printed, by):
    ms, got_by = _ms(work)
    assert f"{ms:.5f}" == printed and got_by == by, (name, ms, got_by)


def test_bound_is_the_larger_of_the_two_times():
    w = roofline.Work(bytes=3.35e9, flops=67e9)      # 1 ms each
    assert _ms(w) == (1.0, "bytes")
    assert _ms(roofline.Work(1.0, 67e9))[1] == "operations"
    assert _ms(2 * w) == (2.0, "bytes")
    assert (w + w) == 2 * w == w * 2


def test_an_unknown_card_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.bound_ms(roofline.Work(1.0, 1.0), "NVIDIA A100-SXM4-80GB")
    assert roofline.peaks(H100) == roofline.Peaks(HBM, F32_RATE)


def test_bf16_values_and_int16_ids_count_two_bytes():
    f32 = roofline.spmv_csr_sliced(1000, 64, 64, 3, counts=False)
    half = roofline.spmv_csr_sliced(1000, 64, 64, 3, counts=False,
                                    value_dtype=torch.bfloat16,
                                    index_dtype=torch.int16)
    assert f32.bytes - half.bytes == 1000 * 4 and f32.flops == half.flops
    gs = roofline.sweep_rows_gs(500, 20, 64, 3)
    gs16 = roofline.sweep_rows_gs(500, 20, 64, 3, value_dtype=torch.bfloat16,
                                  index_dtype=torch.int16)
    assert gs.bytes - gs16.bytes == 500 * 4
    assert (roofline.bbmv(10, 8, 64, 3).bytes
            - roofline.bbmv(10, 8, 64, 3, value_dtype=torch.bfloat16).bytes
            == 10 * 8 * 8 * 2)
    assert (roofline.block_gs_sweep(4, 8, 64, 3).bytes
            - roofline.block_gs_sweep(4, 8, 64, 3,
                                      value_dtype=torch.bfloat16).bytes
            == 4 * 8 * 64 * 2)


# ---------------------------------------------------------------------------
# chip_smoke.py's inline formulas (f32 values and int32 indices: 4 + 4
# bytes a stored nonzero), on small operators
# ---------------------------------------------------------------------------

VAL_B, IDX_B = 4, 4


def _smoke_sweep(nnz_r, picks, n_x, k, per_pick_flops, extra_bytes_per_pick,
                 carries=1):
    nbytes = (float(nnz_r.sum()) * (VAL_B + IDX_B)
              + picks * (k * 4 + 4 + extra_bytes_per_pick)
              + 2 * carries * n_x * k * 4)
    return nbytes, float(per_pick_flops(nnz_r).sum())


def _smoke_spmv(op, k, variant):
    nbytes = op.nnz * (VAL_B + IDX_B) + op.shape[1] * k * 4 \
        + op.shape[0] * k * 4
    if variant.startswith("segsum"):
        nbytes += op.shape[0] * 8
    if variant.endswith("_prefetch"):
        nbytes += op.panel_nnz().numel() * 4
    if variant.startswith("sliced") and op.stop_counts(k) is not None:
        nbytes += op.shape[0] * 4
    return nbytes, 2.0 * op.nnz * k


@pytest.fixture(scope="module")
def csr():
    prob = random_sparse_spd(96, row_nnz=5, n_rhs=1, seed=2, device="cpu")
    return as_operator(prob.A, "csr")


def _equal(work, nbytes, flops):
    assert (work.bytes, work.flops) == pytest.approx((nbytes, flops),
                                                     rel=1e-15)


@pytest.mark.parametrize("name,per_pick,extra,carries", [
    ("sweep_rows_gs", lambda z: 2 * z * K + 3 * K, 0, 1),
    ("sweep_rows_rk", lambda z: 5 * z * K + 3 * K, 4, 1),
    ("sweep_rows_rk_delta", lambda z: 6 * z * K + 3 * K, 4, 2),
])
def test_row_sweeps_equal_the_smoke_formula(csr, name, per_pick, extra,
                                            carries):
    picks = torch.randint(0, 96, (300,),
                          generator=torch.Generator().manual_seed(0))
    nnz_r = csr.row_nnz[picks].double()
    work = getattr(roofline, name)(float(nnz_r.sum()), picks.numel(),
                                   csr.shape[1], K)
    _equal(work, *_smoke_sweep(nnz_r, picks.numel(), csr.shape[1], K,
                               per_pick, extra, carries))


def test_dense_window_equals_the_smoke_formula():
    steps, n = 64, 512
    nbytes = steps * (n * 8 + K * 4 + 8) + 2 * 2 * n * K * 4
    flops = steps * (6.0 * n * K + 3.0 * K)
    _equal(roofline.sweep_rows_rk_delta_window(steps, n, K), nbytes, flops)


def test_block_sweep_on_csr_equals_the_smoke_formula(csr):
    blk = 8
    picks = torch.randint(0, 96 // blk, (12,),
                          generator=torch.Generator().manual_seed(1))
    rows = (picks.long()[:, None] * blk
            + torch.arange(blk)[None, :]).reshape(-1)
    nnz_r = csr.row_nnz[rows].double()
    nbytes = (float(nnz_r.sum()) * (VAL_B + IDX_B) + rows.numel() * K * 4
              + picks.numel() * 4 + 2 * 96 * K * 4)
    flops = float((2 * nnz_r * K + 3 * K).sum())
    _equal(roofline.sweep_rows_block_gs(float(nnz_r.sum()), rows.numel(),
                                        picks.numel(), 96, K), nbytes, flops)


@pytest.mark.parametrize("variant", ["sliced", "sliced_prefetch", "segsum",
                                     "segsum_prefetch"])
@pytest.mark.parametrize("k", [1, K])
def test_matvecs_equal_the_smoke_formula(csr, variant, k):
    m, n = csr.shape
    counts = csr.stop_counts(k) is not None
    panels = csr.panel_nnz().numel()
    work = {
        "sliced": lambda: roofline.spmv_csr_sliced(csr.nnz, m, n, k,
                                                   counts=counts),
        "sliced_prefetch": lambda: roofline.spmv_csr_sliced_prefetch(
            csr.nnz, m, n, k, panels, counts=counts),
        "segsum": lambda: roofline.spmv_csr(csr.nnz, m, n, k),
        "segsum_prefetch": lambda: roofline.spmv_csr_prefetch(
            csr.nnz, m, n, k, panels),
    }[variant]()
    _equal(work, *_smoke_spmv(csr, k, variant))


def test_ell_equals_the_smoke_formula():
    prob = random_sparse_spd(96, row_nnz=5, n_rhs=1, seed=2, device="cpu")
    op = as_operator(prob.A, "ell")
    n, nnz = 96, as_operator(prob.A, "csr").nnz
    stored = int(op.row_counts().sum())
    _equal(roofline.spmv_ell(stored, n, n, K, counts=True),
           stored * (VAL_B + IDX_B) + n * 4 + 2 * n * K * 4, 2.0 * nnz * K)


def test_banded_and_dense_kernels_equal_the_smoke_formulas():
    block, bands, n = 16, 2, 128
    prob = block_banded_spd(n, block=block, bands=bands, device="cpu")
    nb = n // block
    tiles = int(band_valid(nb, bands, "cpu").sum())
    _equal(roofline.bbmv(tiles, block, n, K),
           tiles * block * block * VAL_B + 2 * n * K * 4,
           2.0 * tiles * block * block * K)
    window = n + 2 * bands * block
    per_pick = (2 * bands + 1) * block * block * VAL_B + block * K * 4 + 4
    _equal(roofline.banded_gs_sweep(nb, block, bands, window, K),
           nb * per_pick + 2 * window * K * 4,
           2.0 * nb * (2 * bands + 1) * block * block * K)
    owned = 5
    per_pick = ((2 * bands + 1) * block * block * VAL_B + block * K * 4
                + block * 4 + 8)
    _equal(roofline.banded_rk_sweep(owned, block, bands, window, K),
           owned * per_pick + 2 * 2 * window * K * 4,
           4.0 * owned * (2 * bands + 1) * block * block * K)
    per_pick = block * n * VAL_B + block * K * 4 + 4
    _equal(roofline.block_gs_sweep(nb, block, n, K),
           nb * per_pick + 2 * prob.A.shape[0] * K * 4,
           nb * (2.0 * block * n * K + 3.0 * block * K))
    t = torch.ones(n, K)
    _equal(roofline.colsum(n, K), t.numel() * 4 + K * 4, float(t.numel()))


@pytest.mark.parametrize("action", ["gs", "rk"])
def test_sweep_roofline_adds_a_sweep_and_a_record(csr, action):
    m, n = csr.shape
    r = roofline.sweep_roofline(action, picked_nnz=csr.nnz, picks=m,
                                nnz=csr.nnz, m=m, n=n, k=K, counts=True,
                                device_name=H100)
    mv = roofline.spmv_csr_sliced(csr.nnz, m, n, K, counts=True)
    if action == "gs":
        sweep = roofline.sweep_rows_gs(csr.nnz, m, n, K)
        record = mv + mv + roofline.colsum(m, K) + roofline.colsum(m, K)
    else:
        sweep = roofline.sweep_rows_rk(csr.nnz, m, n, K)
        record = mv + roofline.colsum(n, K) + roofline.colsum(m, K)
    assert (r.sweep, r.record) == (sweep, record)
    assert (r.ms, r.bound_by) == _ms(sweep + record)
    assert r.share(2 * r.ms) == 0.5
    with pytest.raises(ValueError, match="unknown action"):
        roofline.sweep_roofline("cg", picked_nnz=1, picks=1, nnz=1, m=1, n=1,
                                k=1, counts=False, device_name=H100)
