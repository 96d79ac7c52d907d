"""repro_torch's distributed engine at P = 4 against the reference's.

The reference runs on a forced 4-device host mesh in a subprocess
(``conftest.run_forced_device_script``) and writes its problems, its pick
streams (drawn as its strategies draw them) and its results to a file; the
port runs the same problems on the same picks in four spawned processes,
one rank each of a gloo group on the CPU (``launch.mesh.run_workers``).

Tolerance, looser than at P = 1 (tests/test_torch_distributed.py) because
the delta sum runs in another order (gloo's reduction against XLA's psum),
which perturbs every replica by an ulp or so of the delta each round:
rel ||dx|| <= 1e-4, resid and err_sq rtol 1e-3 / atol 1e-5; ``tau`` and
``bytes_per_round`` exactly.
"""
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

P = 4
# name -> (format, format arguments, rounds, local_steps)
CASES = {
    "csr": ("csr", {}, 6, 6),
    "ell": ("ell", dict(width=12), 3, 16),
    "banded": ("banded", dict(block=16, bands=1), 4, 8),
}

REF_SCRIPT = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import as_operator, random_sparse_lsq, spd
    from repro.core.engine import sample_rows, solve_distributed
    from repro.launch.mesh import make_host_mesh

    P = 4
    mesh = make_host_mesh(P)
    cases = CASES
    problems = {
        "csr": random_sparse_lsq(96, 32, row_nnz=5, n_rhs=2, seed=7),
        "ell": spd.random_sparse_spd(64, row_nnz=6, n_rhs=2, seed=6),
        "banded": spd.block_banded_spd(128, block=16, bands=1, n_rhs=2,
                                       seed=2),
    }
    out = {}
    for name, (fmt, kw, R, L) in cases.items():
        prob = problems[name]
        op = as_operator(prob.A, fmt, **kw)
        key = jax.random.key(9)
        rn = op.row_norms_sq()
        if fmt == "banded":
            picks = np.asarray(sample_rows(key, jnp.sum(rn, axis=1),
                                           R * L)).reshape(R, L)
        else:
            slab = rn.shape[0] // P
            keys = jax.random.split(key, R)
            picks = np.stack([np.stack([np.asarray(sample_rows(
                jax.random.fold_in(keys[r], w), rn[w * slab:(w + 1) * slab],
                L)) for w in range(P)]) for r in range(R)])
        x0 = jnp.zeros((op.shape[1], 2), jnp.float32)
        res = solve_distributed(op, prob.b, x0, prob.x_star, action="rk",
                                key=key, mesh=mesh, rounds=R, local_steps=L,
                                beta=0.9, sync="psum", fused=True)
        for field, v in dict(A=prob.A, b=prob.b, x_star=prob.x_star,
                             picks=picks, x=res.x, err_sq=res.err_sq,
                             resid=res.resid, tau=res.tau,
                             bytes=res.bytes_per_round).items():
            out[f"{name}_{field}"] = np.asarray(v)
    np.savez("OUT_PATH", **out)
    print("REF_OK")
"""


def _port_worker(group, device, arrays):
    """One rank of the port's run: every case on the reference's picks."""
    from repro_torch.core.distributed import solve_distributed
    from repro_torch.core.operators import as_operator
    out = {}
    for name, (fmt, kw, rounds, steps) in CASES.items():
        t = {f: torch.from_numpy(arrays[f"{name}_{f}"]).to(device)
             for f in ("A", "b", "x_star", "picks")}
        op = as_operator(t["A"], fmt, **kw)
        res = solve_distributed(
            op, t["b"], torch.zeros_like(t["x_star"]), t["x_star"],
            action="rk", group=group, rounds=rounds, local_steps=steps,
            beta=0.9, sync="psum", picks=t["picks"])
        out[name] = res._asdict()
    return out


def _live_children():
    """The ids of this process's living child processes (Linux /proc)."""
    return [pid for task in Path(f"/proc/{os.getpid()}/task").iterdir()
            for pid in (task / "children").read_text().split()]


def _fail_on_rank_1(group, device):
    import torch.distributed as dist
    if dist.get_rank(group) == 1:
        raise RuntimeError("rank 1 gives up")
    dist.barrier(group)            # rank 0 waits for a peer that is gone
    return "unreachable"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from conftest import run_forced_device_script
    from repro_torch.launch.mesh import run_workers
    path = tmp_path_factory.mktemp("ranks") / "ref.npz"
    run_forced_device_script(
        REF_SCRIPT.replace("OUT_PATH", str(path)).replace(
            "cases = CASES", f"cases = {CASES!r}"),
        num_devices=P, marker="REF_OK", timeout=300)
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
            / np.linalg.norm(want_x)) <= 1e-4
    for field in ("resid", "err_sq"):
        np.testing.assert_allclose(got[field].numpy(), ref[f"{name}_{field}"],
                                   rtol=1e-3, atol=1e-5)
    assert got["tau"] == int(ref[f"{name}_tau"]) > 0
    assert got["bytes_per_round"] == float(ref[f"{name}_bytes"]) > 0
    # the residual falls: four ranks' updates all landed
    assert (got["resid"][-1] < got["resid"][0]).all()


def test_no_process_outlives_the_run(runs):
    """The ranks and the resource tracker that the spawn method starts
    beside them have all ended when ``run_workers`` returns."""
    assert _live_children() == []


def test_a_failing_rank_ends_the_run():
    """A rank that raises ends every rank, and the caller gets an error
    naming the failure, well inside the timeout (a hang would raise
    TimeoutError instead)."""
    from repro_torch.launch.mesh import run_workers
    with pytest.raises(RuntimeError, match=r"rank \d failed"):
        run_workers(_fail_on_rank_1, 2, backend="gloo", device="cpu",
                    timeout=120)
    assert _live_children() == []
