"""tests/test_distributed.py on loraine_tpu_torch: a 2-process solve over
torch.distributed (Gloo, CPU), each process initializing through
`parallel.distributed.initialize` (a FileStore rendezvous, no fixed port),
building the same problem, sharding it over the (2, 1) mesh (blocks across
processes) and solving (`parallel.dryrun --case two_process`, the port of
tests/multiprocess_worker.py). Results must agree across processes to
1e-12, and with the unsharded solve of the same problem."""
import numpy as np

import loraine_tpu_torch as ltt
from loraine_tpu_torch.parallel import dryrun
from loraine_tpu_torch.parallel.distributed import launch


def test_two_process_solve():
    cmd = ["-m", "loraine_tpu_torch.parallel.dryrun", "--device", "cpu",
           "--case", "two_process"]
    recs = dryrun.records(launch(cmd, 2, timeout=240, env={"PYTHONPATH": dryrun._ROOT}))
    assert [r["rank"] for r in recs] == [0, 1]
    for r in recs:
        assert r["status"] == 1
        assert r["mesh"] == [2, 1]
    objs = [r["sharded"] for r in recs]
    np.testing.assert_allclose(objs[0], objs[1], rtol=1e-12)

    rng = np.random.default_rng(0)  # tests/multiprocess_worker.py's problem
    As, Cs = [], []
    for _ in range(2):
        A = rng.standard_normal((12, 8, 8))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((8, 8))
        Cs.append(C @ C.T + 8 * np.eye(8))
    b = rng.standard_normal(12)
    ref = ltt.solve(ltt.problem_from_dense(As, Cs, b, device="cpu"),
                    {"kit": 0, "eDIMACS": 1e-7, "verb": 0}, device="cpu")
    assert ref.status == 1
    np.testing.assert_allclose(objs[0], ref.objective, rtol=1e-8)
