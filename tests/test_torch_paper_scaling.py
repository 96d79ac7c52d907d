"""``repro_torch.paper.fig2_scaling`` at P = 1 (this process) and P = 2 (two
spawned gloo processes through ``launch.mesh.run_workers``) on the CPU, on
the reference's n = 64 problem: tau and the iterations per worker as the
reference's formulas give them, beta~ within 1e-6 of
``repro.core.theory.beta_opt`` on the same matrix, the residual finite and
below 1, x finite on every rank, and each round's all-gather wire bytes
the reference's ring model.  Then on the reference's own streams (its
``parallel_rgs_solve`` at P = 1 and 2 on a forced 2-device host mesh in a
subprocess, with key(0) as the reference's driver passes it, each rank's
picks ``randint(fold_in(split(key, R)[r], w), (L,), 0, L)``, handed to the
driver as ``picks=``): each residual within rtol 1e-4 of the reference's.
Its own file: the spawned ranks and the subprocess take seconds.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import random_sparse_spd as ref_random_sparse_spd  # noqa: E402
from repro.core import theory as ref_theory  # noqa: E402
from repro.roofline import collective_bytes  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.paper import fig2_scaling  # noqa: E402

N, SWEEPS, WORKERS, RHS = 64, 10, (1, 2), 4

REF_SCRIPT = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import parallel_rgs_solve, random_sparse_spd, theory
    from repro.launch.mesh import make_host_mesh

    N, SWEEPS, WORKERS = N_SWEEPS_WORKERS
    prob = random_sparse_spd(N, row_nnz=16, offdiag=0.95, n_rhs=4, seed=0)
    rho = float(theory.rho(prob.A))
    key = jax.random.key(0)
    keys = jax.random.split(key, SWEEPS)
    out = {}
    for P in WORKERS:
        local = N // P
        beta = theory.beta_opt(rho, (P - 1) * local)
        r = parallel_rgs_solve(prob.A, prob.b, jnp.zeros_like(prob.x_star),
                               prob.x_star, key=key, mesh=make_host_mesh(P),
                               rounds=SWEEPS, local_steps=local, beta=beta)
        out[f"picks{P}"] = np.stack([np.stack([np.asarray(
            jax.random.randint(jax.random.fold_in(keys[r], w), (local,), 0,
                               local)) for w in range(P)])
            for r in range(SWEEPS)])
        out[f"resid{P}"] = float(jnp.linalg.norm(r.resid[-1])
                                 / jnp.linalg.norm(prob.b))
    np.savez("OUT_PATH", **out)
    print("REF_OK")
"""


def test_fig2_at_one_and_two_ranks(capsys):
    r = ref_random_sparse_spd(N, row_nnz=16, offdiag=0.95, n_rhs=RHS, seed=0)
    prob = convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                          r.lam_max, "cpu")
    got = fig2_scaling.run(N, SWEEPS, WORKERS, problem=prob)
    out = capsys.readouterr().out
    assert [rec["P"] for rec in got] == list(WORKERS)
    rho = float(ref_theory.rho(r.A))
    for rec in got:
        P = rec["P"]
        local = N // P
        assert rec["tau"] == (P - 1) * local
        assert rec["iters_per_worker"] == SWEEPS * local
        assert rec["sync_rounds"] == SWEEPS
        assert abs(rec["beta"] - ref_theory.beta_opt(rho, rec["tau"])) <= 1e-6
        assert math.isfinite(rec["resid"]) and rec["resid"] < 1
        assert rec["x_finite"] and rec["wall_s"] > 0
        line = (f"%g = f32[{N},{RHS}]{{1,0}} all-gather(f32[{local},{RHS}]"
                f"{{1,0}} %x), replica_groups={{{{"
                + ",".join(map(str, range(P))) + "}}")
        assert rec["ring_wire_bytes"] == collective_bytes(line).wire_bytes
    lines = [ln for ln in out.splitlines()
             if ln.startswith("fig2_scaling,")]
    assert [ln.split(",")[1] for ln in lines] == [f"P={p}" for p in WORKERS]
    keys = [kv.split("=")[0] for kv in lines[0].split(",")[1:]]
    assert keys == ["P", "tau", "beta", "wall_s", "resid_10sweeps",
                    "iters_per_worker", "sync_rounds", "ring_wire_bytes"]
    assert out.count("fig2_scaling_derived,") == len(WORKERS)
    assert np.isfinite([rec["resid"] for rec in got]).all()


def test_fig2_matches_reference_on_its_streams(tmp_path, capsys):
    from conftest import run_forced_device_script
    path = tmp_path / "ref.npz"
    run_forced_device_script(
        REF_SCRIPT.replace("OUT_PATH", str(path)).replace(
            "N_SWEEPS_WORKERS", repr((N, SWEEPS, WORKERS))),
        num_devices=max(WORKERS), marker="REF_OK", timeout=300)
    ref = dict(np.load(path))
    r = ref_random_sparse_spd(N, row_nnz=16, offdiag=0.95, n_rhs=RHS, seed=0)
    prob = convert.spd_problem_from_numpy(r.A, r.b, r.x_star, r.lam_min,
                                          r.lam_max, "cpu")
    got = fig2_scaling.run(
        N, SWEEPS, WORKERS, problem=prob,
        picks={P: torch.from_numpy(ref[f"picks{P}"]) for P in WORKERS})
    capsys.readouterr()
    assert [rec["P"] for rec in got] == list(WORKERS)
    for rec in got:
        want = float(ref[f"resid{rec['P']}"])
        assert rec["x_finite"]
        np.testing.assert_allclose(rec["resid"], want, rtol=1e-4,
                                   err_msg=f"P = {rec['P']}")
