"""The relabeling gives the same problem in another order (CPU)."""
import numpy as np
import pytest

import sdpbench_cells as sc
import instance as I


def _canon(inst):
    """Every entry as (block, mat, row, col, val), sorted."""
    rows = [(b, int(m), int(r), int(c), float(v))
            for b, blk in enumerate(inst.blocks) for m, r, c, v in zip(*blk)]
    return sorted(rows)


def _undo(orig, rel, rng):
    """``rel`` mapped back with the permutations ``rng`` drew."""
    n = orig.nvar
    pc = rng.permutation(n)
    inv_c = np.argsort(pc)
    mat_back = np.concatenate([[0], inv_c + 1])
    blocks = []
    for size, (mat, row, col, val) in zip(orig.block_sizes, rel.blocks):
        p = rng.permutation(abs(size))
        inv = np.argsort(p)
        r, c = inv[row], inv[col]
        blocks.append((mat_back[mat], np.minimum(r, c), np.maximum(r, c), val))
    return I.Instance(n, orig.block_sizes, rel.c[pc], blocks)


@pytest.mark.parametrize("path", [sc.THETA1, sc.TRU3])
def test_relabel_is_a_bijection(path):
    base = I.read_sdpa(path)
    seed = 2**40 + 17  # past 32 bits, as the driver's seeds are
    rel = I.relabel(base, I.request_rng(seed, 3))
    assert _canon(rel) != _canon(base)
    back = _undo(base, rel, I.request_rng(seed, 3))
    assert np.array_equal(back.c, base.c)
    assert _canon(back) == _canon(base)
    for (m, r, c, _), size in zip(rel.blocks, rel.block_sizes):
        assert (r <= c).all() and r.min() >= 0 and c.max() < abs(size)
        if size < 0:
            assert (r == c).all()
    # the same seed and index give the same instance; another index another
    again = I.relabel(base, I.request_rng(seed, 3))
    assert _canon(again) == _canon(rel)
    assert _canon(I.relabel(base, I.request_rng(seed, 4))) != _canon(rel)


def test_relabeled_theta1_solves_to_its_objective():
    import torch  # noqa: F401
    import loraine_tpu_torch as ltt

    base = I.read_sdpa(sc.THETA1)
    opts = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}
    objs = []
    for inst in (base, I.relabel(base, I.request_rng(7, 0))):
        p = ltt.problem_from_sdpa(I.to_program(inst, ltt.SDPAData), device="cpu")
        res = ltt.solve(p, opts, device="cpu")
        assert res.status_name == "OPTIMAL"
        objs.append(res.objective)
    # both within eDIMACS of theta(G) = 23; the same problem, so far closer
    assert abs(objs[0] - 23.0) < 1e-4
    assert abs(objs[1] - objs[0]) / (1 + abs(objs[0])) < 1e-8
