"""The dry run's quantized pod-axis gradient reduce on real shards: reduced
gemma2-2b trained 8 steps on 4 spawned gloo ranks as a (2, 1, 2) ("pod",
"data", "model") mesh under the multi-pod rules, each gradient leaf's
local shard summed over the pods with ``comm.q_psum`` at 8 bits
(``make_train_step(qcomm_bits=8, group=mesh.get_group("pod"))``,
each pod's gradients on the mesh without the pod axis, ``sharding.
pod_local``), against exact training in one process
(``tests/_torch_mesh.py::train_qcomm`` at 0 bits) — to the criteria of the
reference's ``tests/test_qcomm.py``: the exact run falls by 0.5, the first
quantized loss within rel 1e-3 of the exact one (the same weights), the
last within 0.15; every rank holds the same params."""
import numpy as np
import pytest

pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import mesh_pool, sharded_train, train_qcomm  # noqa: E402

pool = mesh_pool(4)


@pytest.fixture(scope="module")
def traces(pool):
    return train_qcomm("gemma2-2b", 0), pool.run(sharded_train, "gemma2-2b", 8, world=4)


def test_exact_reduction_trains(traces):
    exact, _ = traces
    assert exact["losses"][-1] < exact["losses"][0] - 0.5, exact["losses"]


def test_q8_matches_exact_training(traces):
    exact, (q0, *_) = traces
    assert q0["losses"][0] == pytest.approx(exact["losses"][0], rel=1e-3)
    assert abs(q0["losses"][-1] - exact["losses"][-1]) < 0.15, (q0["losses"], exact["losses"])
    assert q0["losses"] != exact["losses"], "the quantized reduce changed nothing"


def test_ranks_hold_the_same_params(traces):
    _, run = traces
    for r in run[1:]:
        assert r["losses"] == run[0]["losses"]
        np.testing.assert_array_equal(r["digest"], run[0]["digest"])
