"""The rest of repro_torch's distributed engine at P = 4 against the
reference's: the Kaczmarz a2a exchange, ``dense_rk``, ``overlap``,
``compress`` and ``partition="balanced"``.

The reference runs on a forced 4-device host mesh in one subprocess
(``conftest.run_forced_device_script``) and writes its problems, its pick
streams (drawn as its strategies draw them) and its results to a file;
the port runs the same problems on the same picks in one
``launch.mesh.run_workers`` call, four gloo ranks on the CPU.  The
reference's local phases are its fused kernels (``fused=True``): the
port's one engine is the fused one.

Exact: the port's a2a iterate, records and x bitwise its psum's (the
delta sum adds the ranks in rank order under both), x the same on every
rank, ``lag`` traces integer for integer the reference's, ``tau`` and
``bytes_per_round`` the reference's.  Within tolerance of the reference
(the port's delta sum adds in rank order, XLA's psum in its own; so every
replica moves by an ulp or so of the delta a round): rel ||dx|| <= 1e-4,
resid and err_sq rtol 1e-3 / atol 1e-5, as in
tests/test_torch_distributed_ranks.py; the compressed runs, whose codec
can round a value that moved by an ulp to the next level (a bf16 level is
2^-8 of the value): rel ||dx|| <= 5e-3, the records rtol 5e-2.  The
lockstep int8_ef and bf16 iterates within rel 5e-2 of the f32 wire's,
the balanced run's residual below 5e-2 of ||b|| and its slabs' norm mass
within 2x of uniform (the reference's bounds).
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

P = 4

REF_SCRIPT = """
    import warnings
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import (as_operator, block_banded_spd, random_lsq,
                            random_sparse_lsq, random_sparse_spd)
    from repro.core import partition as pt
    from repro.core.engine import sample_rows, solve_distributed
    from repro.launch.mesh import make_host_mesh

    P = 4
    mesh = make_host_mesh(P)
    out = {}

    def rk_picks(op, key, R, L):
        rn = op.row_norms_sq()
        slab = rn.shape[0] // P
        keys = jax.random.split(key, R)
        return np.stack([np.stack([np.asarray(sample_rows(
            jax.random.fold_in(keys[r], w), rn[w * slab:(w + 1) * slab], L))
            for w in range(P)]) for r in range(R)])

    def gs_picks(key, R, L, hi):
        keys = jax.random.split(key, R)
        return np.stack([np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(keys[r], w), (L,), 0, hi))
            for w in range(P)]) for r in range(R)])

    def keep(name, prob, res, picks, **extra):
        for f, v in dict(A=prob.A, b=prob.b, x_star=prob.x_star,
                         picks=picks, x=res.x, err_sq=res.err_sq,
                         resid=res.resid, tau=res.tau,
                         bytes=res.bytes_per_round, **extra).items():
            out[f"{name}_{f}"] = np.asarray(v)
        if res.lag is not None:
            out[f"{name}_lag"] = np.asarray(res.lag)

    def run(name, prob, fmt, fkw, action, key, R, L, beta, picks, **kw):
        op = as_operator(prob.A, fmt, **fkw)
        res = solve_distributed(op, prob.b, jnp.zeros((op.shape[1],
                                prob.b.shape[1]), jnp.float32), prob.x_star,
                                action=action, key=key, mesh=mesh, rounds=R,
                                local_steps=L, beta=beta, fused=True, **kw)
        keep(name, prob, res, picks)

    # the Kaczmarz a2a exchange on a banded-structure CSR: a chain graph
    bb = block_banded_spd(512, block=16, bands=1, n_rhs=3, seed=2)
    key = jax.random.key(0)
    cop = as_operator(bb.A, "csr")
    picks = rk_picks(cop, key, 12, 16)
    run("a2a", bb, "csr", {}, "rk", key, 12, 16, 0.9, picks, sync="a2a")
    run("a2a_psum", bb, "csr", {}, "rk", key, 12, 16, 0.9, picks,
        sync="psum")
    # sync="auto" on the unstructured design: a dense graph, the psum
    lp = random_sparse_lsq(256, 64, row_nnz=8, n_rhs=2, seed=0)
    key = jax.random.key(1)
    run("auto", lp, "csr", {}, "rk", key, 8, 8, 0.9,
        rk_picks(as_operator(lp.A, "csr"), key, 8, 8))

    # dense_rk: one global stream of rows, the delta sum
    dp = random_lsq(128, 32, n_rhs=2, col_scale=0.5, seed=4)
    key = jax.random.key(2)
    A = jnp.asarray(dp.A, jnp.float32)
    dpicks = np.asarray(sample_rows(key, jnp.einsum("mn,mn->m", A, A),
                                    6 * 8)).reshape(6, 8)
    run("dense_rk", dp, "dense", {}, "rk", key, 6, 8, 0.5, dpicks,
        sync="psum")

    # overlap: sparse_gs (all-gather and a2a), halo_gs, sparse_rk
    sp = random_sparse_spd(64, row_nnz=6, n_rhs=2, seed=2)
    key = jax.random.key(5)
    run("ov_sparse_gs", sp, "csr", {}, "gs", key, 10, 8, 0.9,
        gs_picks(key, 10, 8, 16), sync="allgather", overlap=True)
    from repro.core import laplacian_spd
    lap = laplacian_spd(8, n_rhs=2, seed=4)
    run("ov_sparse_gs_a2a", lap, "ell", dict(width=5), "gs", key, 6, 8,
        0.9, gs_picks(key, 6, 8, 16), sync="a2a", overlap=True)
    hb = block_banded_spd(256, block=16, bands=1, n_rhs=2, seed=2)
    run("ov_halo_gs", hb, "banded", dict(block=16, bands=1), "gs", key, 10,
        2, 0.9, gs_picks(key, 10, 2, 4), sync="halo", overlap=True)
    run("ov_sparse_rk", sp, "csr", {}, "rk", key, 10, 8, 0.9,
        rk_picks(as_operator(sp.A, "csr"), key, 10, 8), sync="psum",
        overlap=True)
    run("ov_sparse_rk_a2a", bb, "csr", {}, "rk", key, 10, 8, 0.9,
        rk_picks(cop, key, 10, 8), sync="a2a", overlap=True)

    # compress: sparse_rk (psum wire) and halo_gs, both codecs
    cp = random_sparse_lsq(512, 256, row_nnz=6, n_rhs=2, seed=3)
    key = jax.random.key(7)
    cpicks = rk_picks(as_operator(cp.A, "csr"), key, 10, 16)
    for c in ("none", "bf16", "int8_ef"):
        run(f"c_rk_{c}", cp, "csr", {}, "rk", key, 10, 16, 1.0, cpicks,
            sync="psum", compress=c)
    run("c_rk_int8_ef_ov", cp, "csr", {}, "rk", key, 10, 16, 1.0, cpicks,
        sync="psum", compress="int8_ef", overlap=True)
    hpicks = gs_picks(key, 10, 4, 8)
    hb5 = block_banded_spd(512, block=16, bands=1, n_rhs=2, seed=5)
    for c in ("bf16", "int8_ef"):
        run(f"c_halo_{c}", hb5, "banded", dict(block=16, bands=1), "gs",
            key, 10, 4, 0.8, hpicks, sync="halo", compress=c)

    # balanced partition on a norm-skewed design (the reference's test)
    base = random_sparse_lsq(512, 128, row_nnz=8, n_rhs=2, noise=0.0,
                             seed=0)
    Ab = np.array(base.A)
    Ab[:128] *= 20.0
    xt = np.random.default_rng(5).standard_normal((128, 2)).astype(
        np.float32)
    bal = base._replace(A=jnp.asarray(Ab), b=jnp.asarray(Ab @ xt),
                        x_star=jnp.asarray(xt))
    key = jax.random.key(3)
    perm_op, *_ = pt.apply_partition(as_operator(bal.A, "csr"), bal.b,
                                     jnp.zeros((128, 2)), bal.x_star,
                                     action="rk", num_slabs=P)
    run("balanced", bal, "csr", {}, "rk", key, 80, 16, 0.9,
        rk_picks(perm_op, key, 80, 16), partition="balanced")
    # balanced GS: the symmetric permutation, the iterate un-permuted
    gsp = random_sparse_spd(256, row_nnz=8, n_rhs=2, seed=0)
    run("balanced_gs", gsp, "csr", {}, "gs", key, 10, 32, 0.8,
        gs_picks(key, 10, 32, 64), partition="balanced")
    np.savez("OUT_PATH", **out)
    print("REF_OK")
"""

# name -> (format, format arguments, action, rounds, local_steps, beta,
#          solve keywords); the problems and picks come from the reference
CASES = {
    "a2a": ("csr", {}, "rk", 12, 16, 0.9, dict(sync="a2a")),
    "a2a_psum": ("csr", {}, "rk", 12, 16, 0.9, dict(sync="psum")),
    "auto": ("csr", {}, "rk", 8, 8, 0.9, {}),
    "dense_rk": ("dense", {}, "rk", 6, 8, 0.5, dict(sync="psum")),
    "ov_sparse_gs": ("csr", {}, "gs", 10, 8, 0.9,
                     dict(sync="allgather", overlap=True)),
    "ov_sparse_gs_a2a": ("ell", dict(width=5), "gs", 6, 8, 0.9,
                         dict(sync="a2a", overlap=True)),
    "ov_halo_gs": ("banded", dict(block=16, bands=1), "gs", 10, 2, 0.9,
                   dict(sync="halo", overlap=True)),
    "ov_sparse_rk": ("csr", {}, "rk", 10, 8, 0.9,
                     dict(sync="psum", overlap=True)),
    "ov_sparse_rk_a2a": ("csr", {}, "rk", 10, 8, 0.9,
                         dict(sync="a2a", overlap=True)),
    **{f"c_rk_{c}": ("csr", {}, "rk", 10, 16, 1.0,
                     dict(sync="psum", compress=c))
       for c in ("none", "bf16", "int8_ef")},
    "c_rk_int8_ef_ov": ("csr", {}, "rk", 10, 16, 1.0,
                        dict(sync="psum", compress="int8_ef",
                             overlap=True)),
    **{f"c_halo_{c}": ("banded", dict(block=16, bands=1), "gs", 10, 4, 0.8,
                       dict(sync="halo", compress=c))
       for c in ("bf16", "int8_ef")},
    "balanced": ("csr", {}, "rk", 80, 16, 0.9, dict(partition="balanced")),
    "balanced_gs": ("csr", {}, "gs", 10, 32, 0.8,
                    dict(partition="balanced")),
}
# the port's own runs on a case's problem and picks: name -> (the case,
# the keywords that differ, the run it must equal bitwise)
EXTRA = {"a2a_auto": ("a2a", dict(sync="auto"), "a2a"),
         "auto_psum": ("auto", dict(sync="psum"), "auto"),
         "ell_a2a": ("a2a", dict(format="ell", width=48), "ell_psum"),
         "ell_psum": ("a2a", dict(format="ell", width=48, sync="psum"),
                      "ell_a2a")}


def _port_worker(group, device, arrays):
    """One rank: every case on the reference's problems and picks; per run
    x, records, tau, bytes, lag and a SHA-256 of x from every rank."""
    import torch.distributed as dist

    from repro_torch.core.distributed import solve_distributed
    from repro_torch.core.operators import as_operator
    runs = {name: (name, dict(fmt=c[0], fkw=c[1], action=c[2], rounds=c[3],
                              steps=c[4], beta=c[5], kw=c[6]))
            for name, c in CASES.items()}
    for name, (base, change, _) in EXTRA.items():
        c = CASES[base]
        kw = dict(c[6])
        fmt, fkw = c[0], c[1]
        if "format" in change:
            fmt, fkw = change["format"], dict(width=change["width"])
        kw.update({k: v for k, v in change.items()
                   if k not in ("format", "width")})
        runs[name] = (base, dict(fmt=fmt, fkw=fkw, action=c[2],
                                 rounds=c[3], steps=c[4], beta=c[5], kw=kw))
    out = {}
    for name, (src, r) in runs.items():
        t = {f: torch.from_numpy(arrays[f"{src}_{f}"]).to(device)
             for f in ("A", "b", "x_star", "picks")}
        op = as_operator(t["A"], r["fmt"], **r["fkw"])
        res = solve_distributed(
            op, t["b"], torch.zeros((op.shape[1], t["b"].shape[1])),
            t["x_star"], action=r["action"], group=group,
            rounds=r["rounds"], local_steps=r["steps"], beta=r["beta"],
            picks=t["picks"], **r["kw"])
        digest = hashlib.sha256(res.x.numpy().tobytes()).hexdigest()
        ranks = [None] * dist.get_world_size(group)
        dist.all_gather_object(ranks, digest, group=group)
        out[name] = dict(res._asdict(), ranks=ranks)
        if name == "balanced":
            from repro_torch.core import partition as pt
            rp = pt.balanced_row_permutation(op, P)
            out[name]["mass"] = pt.slab_norm_mass(op.row_norms_sq(),
                                                  rp.perm, P)
            out[name]["uniform"] = float(op.row_norms_sq().double().sum()) / P
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from conftest import run_forced_device_script
    from repro_torch.launch.mesh import run_workers
    path = tmp_path_factory.mktemp("rk_ranks") / "ref.npz"
    run_forced_device_script(REF_SCRIPT.replace("OUT_PATH", str(path)),
                             num_devices=P, marker="REF_OK", timeout=300)
    ref = dict(np.load(path))
    port = run_workers(_port_worker, P, ref, backend="gloo", device="cpu",
                       timeout=300)
    return ref, port


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(runs, name):
    ref, port = runs
    got = port[name]
    rtol_x = 5e-3 if "compress" in CASES[name][6] else 1e-4
    assert _rel(got["x"].numpy(), ref[f"{name}_x"]) <= rtol_x
    for field in ("resid", "err_sq"):
        np.testing.assert_allclose(got[field].numpy(), ref[f"{name}_{field}"],
                                   rtol=10 * rtol_x, atol=1e-5)
    assert got["tau"] == int(ref[f"{name}_tau"])
    assert got["bytes_per_round"] == float(ref[f"{name}_bytes"]) > 0
    if f"{name}_lag" in ref:
        assert got["lag"].tolist() == ref[f"{name}_lag"].tolist()
        steps = CASES[name][4]
        lag = got["lag"]
        assert lag[0] == 0 and (lag[1:] == (P - 1) * steps).all()
        base = got["tau"] - (P - 1) * steps       # the lockstep tau
        assert int(lag.max()) + base <= got["tau"]
    else:
        assert got["lag"] is None
    # every rank returns the same x (GS: the owners' slabs; RK where P
    # divides n: the owners' column slabs)
    assert len(set(got["ranks"])) == 1
    assert (got["resid"][-1] < got["resid"][0]).all()


@pytest.mark.parametrize("name", list(EXTRA))
def test_a2a_bitwise_psum_and_auto(runs, name):
    """RK a2a and the psum carry the same bits (x, records) on CSR and
    ELL; sync="auto" is a2a on the chain graph and the psum on the dense
    one."""
    _, port = runs
    got, want = port[name], port[EXTRA[name][2]]
    for f in ("x", "resid", "err_sq"):
        assert torch.equal(got[f], want[f]), f
    assert len(set(got["ranks"])) == 1


def test_a2a_moves_fewer_bytes(runs):
    ref, port = runs
    assert (port["a2a"]["bytes_per_round"]
            < port["a2a_psum"]["bytes_per_round"]
            == float(ref["a2a_psum_bytes"]))
    assert port["auto"]["bytes_per_round"] == 4.0 * 64 * 2


def test_int8_ef_tracks_the_f32_wire(runs):
    _, port = runs
    f32 = port["c_rk_none"]["x"].numpy()
    for name in ("c_rk_int8_ef", "c_rk_bf16"):
        assert _rel(port[name]["x"].numpy(), f32) <= 5e-2, name


def test_balanced_partition_balances_and_converges(runs):
    ref, port = runs
    got = port["balanced"]
    assert got["mass"].max() <= 2 * got["uniform"]
    A, b = ref["balanced_A"], ref["balanced_b"]
    rel = np.linalg.norm(b - A @ got["x"].numpy()) / np.linalg.norm(b)
    assert rel < 5e-2, rel
    # the GS iterate comes back in the original row order: the residual
    # of the original system (the reference's bound, 0.15 of ||b||)
    A, b = ref["balanced_gs_A"], ref["balanced_gs_b"]
    x = port["balanced_gs"]["x"].numpy()
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert rel < 0.15, rel
