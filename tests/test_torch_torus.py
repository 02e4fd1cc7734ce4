"""The toroidal max-cut graphs of chip_smoke.py's last phase, solved through
`maxcut_problem` in both packages on the CPU.

chip_smoke.py builds a 1000- and a 2000-node torus with the port's
`torus_graph` and solves them on the card (B1 and B2 in the "grid" regime);
here the same helper builds a 6 x 5 torus, and the port (the Jacobi
kernels' plain versions) is held against the JAX package (the Pallas
kernels in interpret mode) as tests/test_torch_solve.py's max-cut is: equal
status and iterations, objective within 1e-7 relative (measured 2.2e-11),
the per-iteration errors err1..err6 within 1e-4 relative (measured up to
6.9e-5: the f32 seeds differ at f32 rounding and reach the trajectory
through the steplength bounds).

Run as a script, the file scales iterates that
`python3 -m loraine_tpu_torch.utils.iterates` wrote, with the JAX
package's NT scaling on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_torus.py FILE.npz

For each iterate it prints one JSON line: the JAX package's verdict under
eigh_backend 'pallas' (the TPU's 'auto': `eigh_mixed` on the Pallas Jacobi
seed, here in interpret mode) and 'mixed' (the library's f32 seed), the
smallest eigenvalue `eigh_mixed` returned on the Pallas seed, and M's
spectrum in f64 (numpy).
"""
import json
import sys

import numpy as np

import loraine_tpu as lt
import loraine_tpu_torch as ltt
from loraine_tpu.models.maxcut import maxcut_problem as jax_maxcut_problem
from loraine_tpu_torch.models.maxcut import maxcut_problem, torus_graph
from torch_cases import PALLAS_MODES, errs_agree

OPTS = {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}


def test_torus_graph_is_a_signed_torus():
    W = torus_graph(6, 5, seed=0)
    assert W.shape == (30, 30) and np.array_equal(W, W.T)
    assert (np.abs(W[W != 0]) == 1).all() and (np.diag(W) == 0).all()
    assert ((W != 0).sum(1) == 4).all()  # 4-regular: 60 edges on 30 nodes
    np.testing.assert_array_equal(W, torus_graph(6, 5, seed=0))  # the seed fixes it


def test_torus_maxcut_matches_jax():
    W = torus_graph(6, 5, seed=0)
    rj = lt.solve(jax_maxcut_problem(W, datarank=-1), dict(OPTS, **PALLAS_MODES))
    rt = ltt.solve(maxcut_problem(W, datarank=-1, device="cpu"), dict(OPTS, **PALLAS_MODES),
                   device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iterations == rj.iterations
    assert abs(rt.objective - rj.objective) <= 1e-7 * abs(rj.objective)
    errs_agree(rj, rt, rtol=1e-4)


def test_iterates_scale_alike_in_both_packages(tmp_path, capsys):
    """`loraine_tpu_torch.utils.iterates` on the 6 x 5 torus (the port on
    the CPU), then the script below on the iterates it saved: the JAX
    package's NT scaling gives the same verdicts, M the same spectrum."""
    from loraine_tpu_torch.utils import iterates

    out = tmp_path / "torus.npz"
    assert iterates.main(["6", "5", "0", "--steps", "2", "--out", str(out), "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["k"] for r in recs] == [0, 1, 2]
    assert all(r["nt_ok_auto"] and r["nt_ok_mixed"] for r in recs)
    jax_scale_iterates(str(out))
    jrecs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["k"] for r in jrecs] == [2]  # the last iterate
    for r, j in zip(recs[2:], jrecs):
        assert (j["jax_nt_ok_pallas"], j["jax_nt_ok_mixed"]) == (r["nt_ok_auto"], r["nt_ok_mixed"])
        top = abs(r["M_eig_max"])
        assert abs(j["M_eig_min"] - r["M_eig_min"]) <= 1e-10 * top
        assert abs(j["jax_eigh_mixed_min"] - r["eigh_mixed_min"]) <= 1e-8 * top


def jax_scale_iterates(path: str) -> None:
    """The script: the JAX package's NT scaling on each saved iterate."""
    import jax.numpy as jnp
    from loraine_tpu.ops.eigh import eigh_mixed
    from loraine_tpu.ops.linalg import chol_reg
    from loraine_tpu.ops.nt_scaling import nt_scale

    data = np.load(path)
    for k in sorted(int(key[2:]) for key in data.files if key.startswith("X_")):
        X, S = jnp.asarray(data[f"X_{k}"]), jnp.asarray(data[f"S_{k}"])
        Lx = chol_reg(X, 1e-5, 1000).L
        M = jnp.swapaxes(Lx, -1, -2) @ S @ Lx
        M = (M + jnp.swapaxes(M, -1, -2)) / 2
        ev = np.linalg.eigvalsh(np.asarray(M))
        rec = {"graph": data["graph"].tolist(), "k": k, "M_eig_min": float(ev[0, 0]),
               "M_eig_max": float(ev[0, -1])}
        for backend in ("pallas", "mixed"):
            rec[f"jax_nt_ok_{backend}"] = bool(nt_scale(X, S, eigh_backend=backend).ok)
        lam, _ = eigh_mixed(M, seed="pallas")
        rec["jax_eigh_mixed_min"] = float(lam[0, 0])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    jax_scale_iterates(sys.argv[1])
