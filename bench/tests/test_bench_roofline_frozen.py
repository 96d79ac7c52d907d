"""The frozen work functions, pinned at the four cells' shapes to numbers
worked by hand (not to ``repro_torch.roofline``, which a later change may
edit)."""
import pytest

from bench import roofline_frozen as rf

H100 = "NVIDIA H100 80GB HBM3"
HPCG_N, HPCG_NNZ = 1_124_864, 29_791_000          # 104^3 rows, 310^3 nonzeros
SPD_N, SPD_NNZ = 16_384, 540_360


@pytest.mark.parametrize("work, bytes_, flops", [
    # HPCG, coordinate GS, k = 1, every row picked once:
    # 29,791,000 x 8 + 1,124,864 x (4 + 4) + 2 x 1,124,864 x 4
    (rf.sweep_rows_gs(distinct_nnz=HPCG_NNZ, distinct_rows=HPCG_N,
                      picks=HPCG_N, stream_nnz=HPCG_NNZ, n=HPCG_N, k=1),
     256_325_824, 62_956_592),
    # HPCG, block GS at 8, 140,608 panels each picked once
    (rf.sweep_rows_block_gs(distinct_nnz=HPCG_NNZ, distinct_blocks=140_608,
                            picks=140_608, stream_nnz=HPCG_NNZ, n=HPCG_N, k=1,
                            block=8),
     252_388_800, 62_956_592),
    # the paper's problem, coordinate GS, k = 51
    (rf.sweep_rows_gs(distinct_nnz=SPD_NNZ, distinct_rows=SPD_N, picks=SPD_N,
                      stream_nnz=SPD_NNZ, n=SPD_N, k=51),
     14_415_424, 57_623_472),
    # the paper's problem, block GS at 128, k = 51
    (rf.sweep_rows_block_gs(distinct_nnz=SPD_NNZ, distinct_blocks=128,
                            picks=128, stream_nnz=SPD_NNZ, n=SPD_N, k=51,
                            block=128),
     14_350_400, 57_623_472),
    (rf.spmv_csr(nnz=SPD_NNZ, m=SPD_N, n=SPD_N, k=51), 11_007_552, 55_116_720),
    (rf.spmv_csr(nnz=HPCG_NNZ, m=HPCG_N, n=HPCG_N, k=1),
     247_326_912, 59_582_000),
    (rf.colsum(n=SPD_N, k=51), 3_342_540, 835_584),
    (rf.colsum(n=HPCG_N, k=1), 4_499_460, 1_124_864),
])
def test_work_at_the_cells_shapes(work, bytes_, flops):
    assert work.bytes == bytes_
    assert work.flops == flops


def test_bound_is_the_larger_time_and_needs_published_peaks():
    w = rf.Work(3.35e9, 1.0)
    assert rf.bound_s(w, H100) == pytest.approx(1e-3)
    assert rf.bound_s(rf.Work(1.0, 67e9), H100) == pytest.approx(1e-3)
    assert rf.bound_s(w, "some other card") is None
    assert (rf.Work(1, 2) + rf.Work(3, 4)) == rf.Work(4, 6)
