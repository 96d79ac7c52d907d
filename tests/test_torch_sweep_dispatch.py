"""The host side of the sweeps' two CUDA paths and of the launchers' C
interface, on the CPU (nothing is built; the kernels run only on the card,
where chip_smoke.py holds both paths of each sweep against the plain
version and against each other).

- ``sweep_csr.fits_shared``: the size rule that picks the shared-memory
  path (one RHS column a CTA) or the global path, as the GS sweep calls
  it (one carry) and as the RK sweeps call it (one or two).
- ``banded_gs.fits_shared`` / ``plan``: the banded sweeps' size rule
  (the window column beside a ring of tile stages) and the ring it
  leaves, against the H100's opt-in capacity.
- ``sweep_csr.sweep_rows_gs`` / ``sweep_rows_rk`` / ``sweep_rows_rk_delta``
  / ``bbmv.bbmv`` / ``colsum.colsum`` / ``banded_gs.banded_gs_sweep`` /
  ``banded_rk_sweep``: what they hand the C entry (a stand-in records the
  call), so the argument lists, the iterate's row count and the private
  overrides are checked without a card.
- Every C entry the launchers load is declared ``extern "C"`` in its
  ``csrc/*.cu`` source with as many parameters as its ctypes list
  (the sources are parsed as text).
"""
import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import banded_gs as banded_mod  # noqa: E402
from repro_torch.kernels import bbmv as bbmv_mod  # noqa: E402
from repro_torch.kernels import block_gs as block_gs_mod  # noqa: E402
from repro_torch.kernels import colsum as colsum_mod  # noqa: E402
from repro_torch.kernels import sweep_csr  # noqa: E402

CAP = 232448          # the opt-in shared memory of an H100 CTA, bytes
N_MAIN = 16384        # the main path's iterate rows
N_LSQ = 4096          # the main-path LSQ's iterate rows (the RK sweeps)


@pytest.mark.parametrize("rows, capacity, want", [
    # n * 4 bytes against the capacity, at the boundary
    (CAP // 4, CAP, True),
    (CAP // 4 + 1, CAP, False),
    (N_MAIN, CAP, True),              # the main path's n
    (131072, CAP, False),             # the global path's check shape
    (0, CAP, True),                   # no row
    (N_MAIN, 0, False),               # no shared memory
    (1, 4, True),
    (1, 3, False),
])
def test_gs_fits_shared(rows, capacity, want):
    assert sweep_csr.fits_shared(rows, capacity) is want


@pytest.mark.parametrize("rows, capacity, carries, want", [
    # rows * carries * 4 bytes against the capacity, at the boundary
    (CAP // 4, CAP, 1, True),
    (CAP // 4 + 1, CAP, 1, False),
    (CAP // 8, CAP, 2, True),
    (CAP // 8 + 1, CAP, 2, False),
    (N_LSQ, CAP, 1, True),            # the main path's RK sweep
    (N_LSQ, CAP, 2, True),            # its delta sweep, at P = 1 and 4
    (65536, CAP, 1, False),           # the global path's check shape
    (65536, CAP, 2, False),
    (N_LSQ, 0, 1, False),             # no shared memory
    (0, 0, 2, True),                  # no row
])
def test_rk_fits_shared(rows, capacity, carries, want):
    assert sweep_csr.fits_shared(rows, capacity, carries) is want


def test_gs_rule_holds_every_row_of_x_with_write_base():
    """With write_base > 0 a pick writes row write_base + r, anywhere in x:
    the rule sizes shared memory by x's rows, not by the window count."""
    m, n = 100, 250
    write_base = n - m
    capacity = 4 * (m + 10)           # room for m rows but not n
    assert sweep_csr.fits_shared(m, capacity)
    assert not sweep_csr.fits_shared(n, capacity)
    assert write_base + m == n


class _Entry:
    """Stands in for a loaded C entry: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """The launchers' C entries and stream lookup replaced, so they run on
    CPU tensors up to the call."""
    entries = {}

    def c_entry(source, kernel, vals_dtype, cols_dtype, argtypes):
        entry = entries.setdefault(kernel, _Entry())
        entry.argtypes = argtypes
        return entry

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "c_entry", c_entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        _Stream())
    monkeypatch.setattr(sweep_csr, "shared_capacity", lambda device: CAP)
    monkeypatch.setattr(sweep_csr, "LAUNCHES", dict(sweep_csr.LAUNCHES))
    monkeypatch.setattr(bbmv_mod, "LAUNCHES", dict(bbmv_mod.LAUNCHES))
    monkeypatch.setattr(banded_mod, "LAUNCHES", dict(banded_mod.LAUNCHES))
    return entries


def _gs_inputs(m, n, k, width=5):
    vals = torch.ones((m, width))
    cols = torch.zeros((m, width), dtype=torch.int32)
    b = torch.zeros((m, k))
    x = torch.zeros((n, k))
    picks = torch.zeros((7,), dtype=torch.int32)
    return vals, cols, b, x, picks


@pytest.mark.parametrize("n, override, want_shared", [
    (N_MAIN, None, 1),
    (CAP // 4 + 1, None, 0),
    (N_MAIN, False, 0),
    (CAP // 4 + 1, True, 1),
])
def test_gs_launcher_passes_the_path(fake_launch, n, override, want_shared):
    m, k = 40, 3
    vals, cols, b, x, picks = _gs_inputs(m, n, k)
    kw = {} if override is None else {"_shared": override}
    sweep_csr.sweep_rows_gs(vals, cols, b, x, picks, beta=0.5,
                            write_base=n - m, limit=m, **kw)
    entry = fake_launch["sweep_rows_gs"]
    (args,) = entry.calls
    assert len(args) == len(entry.argtypes) == len(sweep_csr._GS_ARGS)
    width, rows, kk, steps, limit, wb, beta, shared = args[5:13]
    assert (width, rows, kk, steps, limit, wb, beta, shared) == (
        5, n, k, 7, m, n - m, 0.5, want_shared)
    assert sweep_csr.LAUNCHES["sweep_rows_gs"] == 1


@pytest.mark.parametrize("n, k, steps", [(0, 3, 0), (10, 0, 4), (10, 3, 0)])
def test_gs_launcher_without_work_launches_nothing(fake_launch, n, k, steps):
    vals, cols, b, x, _ = _gs_inputs(n, n, k)
    picks = torch.zeros((steps,), dtype=torch.int32)
    out = sweep_csr.sweep_rows_gs(vals, cols, b, x, picks, beta=1.0,
                                  write_base=0, limit=n)
    assert out.shape == x.shape
    assert "sweep_rows_gs" not in fake_launch
    assert sweep_csr.LAUNCHES["sweep_rows_gs"] == 0


def _rk_inputs(m, n, k, width=5):
    vals = torch.ones((m, width))
    cols = torch.zeros((m, width), dtype=torch.int32)
    b = torch.zeros((m, k))
    rn = torch.ones((m,))
    x = torch.zeros((n, k))
    picks = torch.zeros((7,), dtype=torch.int32)
    return vals, cols, b, rn, x, picks


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("n, override, want", [
    (N_LSQ, None, (1, 1)),
    (CAP // 8 + 1, None, (1, 0)),     # x fits, x and d do not
    (CAP // 4 + 1, None, (0, 0)),
    (N_LSQ, False, (0, 0)),
    (CAP // 4 + 1, True, (1, 1)),
])
def test_rk_launchers_pass_the_path(fake_launch, delta, n, override, want):
    """The RK launchers hand the C entry the iterate's rows and the path:
    the size rule at one carry (x) or two (x and d), or the override."""
    m, k = 40, 3
    vals, cols, b, rn, x, picks = _rk_inputs(m, n, k)
    kw = {} if override is None else {"_shared": override}
    if delta:
        xo, do = sweep_csr.sweep_rows_rk_delta(vals, cols, b, rn, x, x, picks,
                                               beta=0.5, limit=m, **kw)
        assert xo.shape == do.shape == x.shape
        name, argtypes, first = ("sweep_rows_rk_delta",
                                 sweep_csr._RK_DELTA_ARGS, 7)
    else:
        assert sweep_csr.sweep_rows_rk(vals, cols, b, rn, x, picks, beta=0.5,
                                       limit=m, **kw).shape == x.shape
        name, argtypes, first = "sweep_rows_rk", sweep_csr._RK_ARGS, 6
    entry = fake_launch[name]
    (args,) = entry.calls
    assert len(args) == len(entry.argtypes) == len(argtypes)
    assert args[first:first + 7] == (5, n, k, 7, m, 0.5, want[delta])
    assert sweep_csr.LAUNCHES[name] == 1


@pytest.mark.parametrize("n, want", [
    (0, 1), (1, 1), (colsum_mod.ROWS_PER_SLICE, 1),
    (colsum_mod.ROWS_PER_SLICE + 1, 2), (16384, 64)])
def test_colsum_slices_depend_on_rows_alone(n, want):
    """The first kernel's row runs, and so the order of a column's adds,
    are fixed by n: the same for any k."""
    assert colsum_mod.slices(n) == want


@pytest.mark.parametrize("delta", [False, True])
def test_rk_launchers_without_work_launch_nothing(fake_launch, delta):
    vals, cols, b, rn, x, _ = _rk_inputs(10, 10, 3)
    picks = torch.zeros((0,), dtype=torch.int32)
    if delta:
        sweep_csr.sweep_rows_rk_delta(vals, cols, b, rn, x, x, picks,
                                      beta=1.0, limit=10)
    else:
        sweep_csr.sweep_rows_rk(vals, cols, b, rn, x, picks, beta=1.0,
                                limit=10)
    assert not fake_launch
    assert sweep_csr.LAUNCHES == dict.fromkeys(sweep_csr.LAUNCHES, 0)


@pytest.mark.parametrize("n, k", [(16384, 51), (1, 1), (0, 3)])
def test_colsum_launcher_passes_the_shape(monkeypatch, n, k):
    entry = _Entry()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "entry", lambda source, name, argtypes: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        _Stream())
    monkeypatch.setattr(colsum_mod, "LAUNCHES", dict(colsum_mod.LAUNCHES))
    out = colsum_mod.colsum(torch.zeros((n, k)))
    assert out.shape == (k,)
    (args,) = entry.calls
    assert len(args) == len(colsum_mod._ARGS)
    assert args[3:6] == (n, k, colsum_mod.slices(n))
    assert colsum_mod.LAUNCHES["colsum"] == 1


@pytest.mark.parametrize("col_warps", [0, 1, 2, 4])
def test_bbmv_launcher_passes_the_column_tile(fake_launch, col_warps):
    nb, bands, block, k = 3, 1, 8, 5
    A = torch.zeros((nb, 2 * bands + 1, block, block))
    x = torch.zeros((nb * block, k))
    y = bbmv_mod.bbmv(A, x, bands=bands, block=block, _col_warps=col_warps)
    assert y.shape == (nb * block, k)
    entry = fake_launch["bbmv"]
    (args,) = entry.calls
    assert len(args) == len(entry.argtypes) == len(bbmv_mod._ARGS)
    assert args[3:8] == (nb, bands, block, k, col_warps)
    assert bbmv_mod.LAUNCHES["bbmv"] == 1


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def _c_entries(source: str) -> dict[str, int]:
    """``extern "C"`` functions of a CUDA source -> their parameter count,
    written out or generated by a function-like macro."""
    text = _strip_comments(source).replace("\\\n", " ")
    count = {}
    macros = {}
    for name, params, body in re.findall(
            r"#define\s+(\w+)\(([^)]*)\)(.*)", text):
        m = re.search(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', body)
        if m:
            macros[name] = (params.split(",")[0].strip(), m.group(1),
                            len([p for p in m.group(2).split(",")
                                 if p.strip()]))
    for m in re.finditer(r'extern\s+"C"\s+\w+\s+(\w+)\s*\(([^)]*)\)', text):
        if any(m.group(1) == slot for slot, _, _ in macros.values()):
            continue          # a macro's own body
        count[m.group(1)] = len([p for p in m.group(2).split(",")
                                 if p.strip()])
    for macro, (slot, fn, n) in macros.items():
        for arg in re.findall(rf"^\s*{macro}\(\s*(\w+)\s*,", text, flags=re.M):
            count[arg if fn == slot else fn] = n
    return count


def _entry_cases():
    cases = []
    for module, source in ((sweep_csr, "sweep_csr"), (bbmv_mod, "bbmv"),
                           (colsum_mod, "colsum"), (banded_mod, "banded_gs"),
                           (block_gs_mod, "block_gs")):
        for name, argtypes in module.C_ENTRIES.items():
            cases.append(pytest.param(source, name, argtypes,
                                      id=f"{source}-{name}"))
    return cases


@pytest.mark.parametrize("source, name, argtypes", _entry_cases())
def test_launcher_entries_are_declared(source, name, argtypes):
    declared = _c_entries((_build.CSRC / f"{source}.cu").read_text())
    assert name in declared, f"{name} is not an extern \"C\" entry of " \
        f"csrc/{source}.cu (found {sorted(declared)})"
    assert declared[name] == len(argtypes)


def test_entry_tables_cover_every_type_pair():
    gs = {n for n in sweep_csr.C_ENTRIES if n.startswith("sweep_rows_gs_")}
    assert gs == {f"sweep_rows_gs_{s}" for s in _build.SUFFIX.values()}
    assert set(bbmv_mod.C_ENTRIES) == {
        f"bbmv_{s}" for s in _build.VALUE_SUFFIX.values()}
    assert set(banded_mod.C_ENTRIES) == {
        f"{kernel}_{s}" for kernel in ("banded_gs_sweep", "banded_rk_sweep")
        for s in _build.VALUE_SUFFIX.values()}
    assert sweep_csr.C_ENTRIES["sweep_shared_capacity"] == [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]


# The banded sweeps (csrc/banded_gs.cu).  At block 128, bands 2 in f32 a
# stage is 4 slices of 8 rows, 4 * (8 * 512 + 16) = 16448 bytes; the rule
# asks for 6 of them beside the mbarriers (256), the parts (1280) and g
# (512): 100736 bytes, which leaves 131712 bytes, 32928 rows, for the
# window column.
BANDED_ROWS_MAX = 32928
BANDED_MAIN = (128 + 4) * 128     # the main path's window: nb 128, halos
BANDED_P4 = (32 + 4) * 128        # a P = 4 rank's window


@pytest.mark.parametrize("rows_w, want", [
    (BANDED_ROWS_MAX, True),
    (BANDED_ROWS_MAX + 1, False),     # 4 more bytes round up to 16
    (BANDED_ROWS_MAX + 4, False),
    (BANDED_MAIN, True),
    (BANDED_P4, True),
    (65536, False),                   # too tall: the global path
])
def test_banded_fits_shared(rows_w, want):
    assert banded_mod.fits_shared(rows_w, 128, 2, 4, CAP) is want
    assert (banded_mod.smem_bytes(128, 2, 4, 32, 6, rows_w, True)
            <= CAP) is want


@pytest.mark.parametrize("rows_w, itemsize, shared, want", [
    (BANDED_MAIN, 4, True, (32, 9)),
    (BANDED_MAIN, 2, True, (32, 16)),
    (BANDED_P4, 4, True, (32, 12)),
    (65536, 4, False, (32, 13)),
])
def test_banded_plan_fills_the_capacity(rows_w, itemsize, shared, want):
    rows, stages = banded_mod.plan(rows_w, 128, 2, itemsize, CAP, shared)
    assert (rows, stages) == want
    assert banded_mod.smem_bytes(128, 2, itemsize, rows, stages, rows_w,
                                 shared) <= CAP
    assert stages == banded_mod.MAX_STAGES or banded_mod.smem_bytes(
        128, 2, itemsize, rows, stages + 1, rows_w, shared) > CAP


@pytest.mark.parametrize("block, bands", [(256, 7), (256, 2), (18, 7),
                                          (20, 1), (1, 0), (256, 18),
                                          (128, 36), (18, 201)])
def test_banded_plan_always_leaves_a_full_row_group(block, bands):
    """Shapes up to the most bands the capacity holds get a ring of at
    least 2*bands+2 stages on the global path (the Kaczmarz sweep holds one
    stage per band of a row group), shrinking the stage where it must."""
    rows, stages = banded_mod.plan(0, block, bands, 4, CAP, False)
    assert stages >= 2 * bands + 2 and rows in banded_mod.STAGE_ROWS
    assert banded_mod.smem_bytes(block, bands, 4, rows, stages, 0,
                                 False) <= CAP


def test_banded_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="no stage ring fits"):
        banded_mod.plan(BANDED_MAIN, 128, 2, 4, 70000, True)


@pytest.mark.parametrize("block, bands", [(256, 19), (128, 37), (18, 202)])
def test_banded_plan_bounds_the_bands_by_capacity(block, bands):
    """One more band than the largest of
    ``test_banded_plan_always_leaves_a_full_row_group``: 2*bands+2 stages
    of the smallest stage no longer fit beside the rest."""
    with pytest.raises(ValueError, match="no stage ring fits"):
        banded_mod.plan(0, block, bands, 4, CAP, False)


@pytest.mark.parametrize("block, bands, itemsize, want", [
    (256, 7, 4, (8, 16)),
    (256, 7, 2, (16, 16)),
    (256, 12, 4, (4, 26)),   # the smallest stage
    (256, 12, 2, (8, 26)),
    (128, 12, 4, (8, 26)),
    (18, 12, 4, (32, 26)),
])
def test_banded_plan_past_one_warp_a_band(block, bands, itemsize, want):
    """Past 7 bands (15 consumer warps) the ring grows to 2*bands+2
    stages, beyond ``MAX_STAGES``, shrinking the stage to fit."""
    rows, stages = banded_mod.plan(0, block, bands, itemsize, CAP, False)
    assert (rows, stages) == want
    assert banded_mod.smem_bytes(block, bands, itemsize, rows, stages, 0,
                                 False) <= CAP


def test_banded_constants_match_the_source():
    text = (_build.CSRC / "banded_gs.cu").read_text()
    for const, value in (("kMaxStageRows", banded_mod.STAGE_ROWS[0]),
                         ("kSlices", banded_mod.SLICES),
                         ("kConsumers", banded_mod.CONSUMERS),
                         ("kMaxBlock", 256)):
        assert re.search(rf"constexpr int {const} = {value};", text), const


def _banded_inputs(nb, block, bands, k, steps=7, dtype=torch.float32):
    A = torch.zeros((nb, 2 * bands + 1, block, block), dtype=dtype)
    b = torch.zeros((nb * block, k))
    xw = torch.zeros(((nb + 2 * bands) * block, k))
    rn = torch.ones((nb, block))
    picks = torch.zeros((steps,), dtype=torch.int32)
    return A, b, rn, xw, picks


# block 8, bands 1, nb 10: a 96-row window, 5792 bytes on the shared path
# (mbarriers 256, 4 stages of 4 * (8 * 32 + 16) = 1088, parts 768, g 32,
# window 384)
SMALL_CAP = 5792


@pytest.mark.parametrize("rk", [False, True])
@pytest.mark.parametrize("capacity, override, k, want", [
    (SMALL_CAP, None, 3, (1, 32, 4)),
    (SMALL_CAP - 1, None, 51, (0, 32, 4)),      # the global path
    (SMALL_CAP, False, 51, (0, 32, 4)),
    (SMALL_CAP + 1088, True, 1, (1, 32, 5)),    # one stage more
    (SMALL_CAP - 1, True, 1, (1, 16, 8)),       # forced: smaller stages
    (CAP, None, 1, (1, 32, 16)),
])
def test_banded_launchers_pass_the_plan(fake_launch, monkeypatch, rk,
                                        capacity, override, k, want):
    monkeypatch.setattr(sweep_csr, "shared_capacity",
                        lambda device: capacity)
    nb, block, bands = 10, 8, 1
    A, b, rn, xw, picks = _banded_inputs(nb, block, bands, k)
    kw = dict(block=block, bands=bands, beta=0.5, limit=nb, _shared=override)
    if rk:
        gates = torch.ones_like(picks)
        xo, do = banded_mod.banded_rk_sweep(A, b, rn, xw, xw, picks, gates,
                                            **kw)
        assert xo.shape == do.shape == xw.shape
        name, argtypes, first = "banded_rk_sweep", banded_mod._RK_ARGS, 7
    else:
        assert banded_mod.banded_gs_sweep(A, b, xw, picks,
                                          **kw).shape == xw.shape
        name, argtypes, first = "banded_gs_sweep", banded_mod._ARGS, 4
    entry = fake_launch[name]
    (args,) = entry.calls
    assert len(args) == len(entry.argtypes) == len(argtypes)
    assert args[first:first + 6] == (7, nb, bands, block, k, 0.5)
    assert args[first + 6:first + 9] == want
    assert banded_mod.LAUNCHES[name] == 1


@pytest.mark.parametrize("rk", [False, True])
@pytest.mark.parametrize("k, steps", [(0, 4), (3, 0), (0, 0)])
def test_banded_launchers_without_work_launch_nothing(fake_launch, rk, k,
                                                      steps):
    A, b, rn, xw, picks = _banded_inputs(4, 8, 1, k, steps)
    kw = dict(block=8, bands=1, beta=1.0, limit=4)
    if rk:
        xo, do = banded_mod.banded_rk_sweep(A, b, rn, xw, xw, picks,
                                            torch.ones_like(picks), **kw)
        assert xo.shape == do.shape == xw.shape
    else:
        assert banded_mod.banded_gs_sweep(A, b, xw, picks,
                                          **kw).shape == xw.shape
    assert not fake_launch
    assert banded_mod.LAUNCHES == dict.fromkeys(banded_mod.LAUNCHES, 0)


@pytest.mark.parametrize("rk", [False, True])
@pytest.mark.parametrize("bands, want", [(7, (1, 32, 16)),
                                         (8, (1, 32, 18)),
                                         (12, (1, 32, 26))])
def test_banded_launchers_take_any_bands(fake_launch, rk, bands, want):
    """More bands than consumer warps go to the same C entry, with a ring
    of 2*bands+2 stages (the Kaczmarz sweep holds a row group's 2*bands+1
    at once)."""
    nb, block = 3, 8
    A, b, rn, xw, picks = _banded_inputs(nb, block, bands, 2)
    kw = dict(block=block, bands=bands, beta=1.0, limit=nb)
    if rk:
        banded_mod.banded_rk_sweep(A, b, rn, xw, xw, picks,
                                   torch.ones_like(picks), **kw)
        name, first = "banded_rk_sweep", 7
    else:
        banded_mod.banded_gs_sweep(A, b, xw, picks, **kw)
        name, first = "banded_gs_sweep", 4
    (args,) = fake_launch[name].calls
    assert args[first + 2] == bands
    assert args[first + 6:first + 9] == want
