"""repro_torch's distributed Gauss-Seidel at P = 4 against the reference's.

The reference runs on a forced 4-device host mesh in a subprocess
(``conftest.run_forced_device_script``) and writes its problems, its pick
streams (drawn as its GS strategies draw them), its results and the a2a
rotations and accept masks it dispatched (read by wrapping its
``_distributed_impl``) to a file; the port runs the same problems on the
same picks in four spawned processes, one rank each of a gloo group on the
CPU (``launch.mesh.run_workers``), once for every case.

Tolerance: rel ||dx|| <= 1e-5 and resid / err_sq rtol 1e-4 / atol 1e-5,
as at P = 1 (tests/test_torch_distributed_gs.py): the GS exchanges copy
slabs, so no sum runs in another order except the records' (gloo's
all-reduce against XLA's psum); ``tau`` and ``bytes_per_round`` exactly.
Within the port, bitwise: the a2a iterates and records equal the
all-gather's on the same picks, ``halo_gs``'s equal ``banded_gs``'s, and
the returned x is the same on every rank.
"""
import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")

P = 4
# name -> (strategy, format, problem, sync, gs_block, rounds, local_steps,
#          format arguments)
CASES = {
    "csr_a2a": ("sparse_gs", "csr", "laplacian", "a2a", 1, 4, 10, {}),
    "ell_a2a": ("sparse_gs", "ell", "laplacian", "a2a", 1, 4, 10,
                dict(width=5)),
    "csr_auto": ("sparse_gs", "csr", "sparse", "auto", 1, 5, 12, {}),
    "banded": ("banded_gs", "banded", "banded", "allgather", 1, 6, 2,
               dict(block=16, bands=1)),
    "halo": ("halo_gs", "banded", "banded", "halo", 1, 6, 2,
             dict(block=16, bands=1)),
    "dense": ("dense_gs", "dense", "banded", "allgather", 4, 6, 6, {}),
}
# the port's own runs on a case's picks under another sync
TWINS = {"csr_a2a_allgather": ("csr_a2a", "allgather"),
         "ell_a2a_allgather": ("ell_a2a", "allgather")}

REF_SCRIPT = """
    import jax, numpy as np
    from repro.core import as_operator, engine, spd
    from repro.launch.mesh import make_host_mesh

    P = 4
    mesh = make_host_mesh(P)
    cases = CASES
    problems = {
        "laplacian": spd.laplacian_spd(8, n_rhs=2, seed=4),
        "sparse": spd.random_sparse_spd(64, row_nnz=6, n_rhs=2, seed=6),
        "banded": spd.block_banded_spd(128, block=16, bands=1, n_rhs=2,
                                       seed=2),
    }
    seen = {}
    impl = engine._distributed_impl

    def spy(*args, **kw):
        seen.update(sync=kw["sync"], schedule=kw["a2a_schedule"],
                    masks=kw["a2a_masks"])
        return impl(*args, **kw)

    engine._distributed_impl = spy
    out = {}
    for name, (kind, fmt, prob_name, sync, gsb, R, L, kw) in cases.items():
        prob = problems[prob_name]
        op = as_operator(prob.A, fmt, **kw)
        n = prob.A.shape[0]
        hi = (n // P // kw["block"] if kind in ("banded_gs", "halo_gs")
              else n // P // gsb)
        key = jax.random.key(11)
        keys = jax.random.split(key, R)
        picks = np.stack([np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(keys[r], w), (L,), 0, hi))
            for w in range(P)]) for r in range(R)])
        x0 = np.zeros_like(np.asarray(prob.b))
        res = engine.solve_distributed(
            op, prob.b, x0, prob.x_star, action="gs", key=key, mesh=mesh,
            rounds=R, local_steps=L, block=gsb, beta=0.9, sync=sync)
        masks = seen["masks"]
        for field, v in dict(
                A=prob.A, b=prob.b, x_star=prob.x_star, picks=picks,
                x=res.x, err_sq=res.err_sq, resid=res.resid, tau=res.tau,
                bytes=res.bytes_per_round, sync=seen["sync"],
                schedule=repr(seen["schedule"]),
                masks=np.zeros((0,), bool) if masks is None else masks,
        ).items():
            out[f"{name}_{field}"] = np.asarray(v)
    np.savez("OUT_PATH", **out)
    print("REF_OK")
"""


def _port_worker(group, device, arrays):
    """One rank of the port's run: every case, and the twins, on the
    reference's picks; each result with every rank's x."""
    import torch.distributed as dist

    from repro_torch.core.distributed import solve_distributed
    from repro_torch.core.operators import as_operator
    runs = dict({name: (name, case[3]) for name, case in CASES.items()},
                **TWINS)
    out = {}
    for name, (case, sync) in runs.items():
        _, fmt, _, _, gsb, rounds, steps, kw = CASES[case]
        t = {f: torch.from_numpy(arrays[f"{case}_{f}"]).to(device)
             for f in ("A", "b", "x_star", "picks")}
        res = solve_distributed(
            as_operator(t["A"], fmt, **kw), t["b"],
            torch.zeros_like(t["b"]), t["x_star"], action="gs", group=group,
            rounds=rounds, local_steps=steps, block=gsb, beta=0.9, sync=sync,
            picks=t["picks"])
        xs = [None] * dist.get_world_size(group)
        dist.all_gather_object(xs, res.x.cpu(), group=group)
        out[name] = dict(res._asdict(), x_ranks=xs)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from conftest import run_forced_device_script
    from repro_torch.launch.mesh import run_workers
    path = tmp_path_factory.mktemp("ranks") / "ref.npz"
    run_forced_device_script(
        REF_SCRIPT.replace("OUT_PATH", str(path)).replace(
            "cases = CASES", f"cases = {CASES!r}"),
        num_devices=P, marker="REF_OK", timeout=600)
    ref = dict(np.load(path))
    port = run_workers(_port_worker, P, ref, backend="gloo", device="cpu",
                       timeout=300)
    return ref, port


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_reference(runs, name):
    ref, port = runs
    got = port[name]
    want_x = ref[f"{name}_x"]
    assert (np.linalg.norm(got["x"].numpy() - want_x)
            / np.linalg.norm(want_x)) <= 1e-5
    for field in ("resid", "err_sq"):
        np.testing.assert_allclose(got[field].numpy(), ref[f"{name}_{field}"],
                                   rtol=1e-4, atol=1e-5)
    assert got["tau"] == int(ref[f"{name}_tau"]) == 3 * CASES[name][6]
    assert got["bytes_per_round"] == float(ref[f"{name}_bytes"]) > 0
    # the returned iterate is the assembled one, the same on every rank
    assert all(torch.equal(x, got["x"]) for x in got["x_ranks"])
    assert (got["resid"][-1] < got["resid"][0]).all()


@pytest.mark.parametrize("name", ["csr_a2a", "ell_a2a", "csr_auto"])
def test_a2a_plan_matches_reference(runs, name):
    """The neighbor graph, the rotations and the accept masks are the
    reference's; the Laplacian's slabs read only their neighbors (two
    rotations), the random problem's graph is dense (auto resolves to
    a2a, which falls back to the all-gather)."""
    from repro_torch.core import distributed
    from repro_torch.core.operators import as_operator
    ref, _ = runs
    _, fmt, _, _, _, _, _, kw = CASES[name]
    op = as_operator(torch.from_numpy(ref[f"{name}_A"]), fmt, **kw)
    need = op.slab_neighbors(P)
    if name == "csr_auto":
        assert need.all() and str(ref[f"{name}_sync"]) == "allgather"
        assert ref[f"{name}_schedule"] == "()"
        return
    schedule, masks = distributed._a2a_plan(need, P)
    assert str(ref[f"{name}_sync"]) == "a2a"
    assert schedule == ast.literal_eval(str(ref[f"{name}_schedule"]))
    assert np.array_equal(masks, ref[f"{name}_masks"])
    assert [s for s, _ in schedule] == [1, 3]
    assert schedule[0][1] == ((0, 1), (1, 2), (2, 3))    # a chain, no wrap


def test_a2a_is_bitwise_the_allgather(runs):
    _, port = runs
    for name in ("csr_a2a", "ell_a2a"):
        a2a, ag = port[name], port[f"{name}_allgather"]
        for field in ("x", "resid", "err_sq"):
            assert torch.equal(a2a[field], ag[field]), (name, field)
        # the a2a sends its slab along the chain only: 6 sends over the 4
        # ranks, each the slab the all-gather's rank contributes once
        assert a2a["bytes_per_round"] == ag["bytes_per_round"] * 6 / P


def test_halo_is_bitwise_banded(runs):
    _, port = runs
    assert torch.equal(port["halo"]["x"], port["banded"]["x"])
    # two edges of bands * block = 16 rows: a slab of 32
    assert port["halo"]["bytes_per_round"] == port["banded"][
        "bytes_per_round"]
