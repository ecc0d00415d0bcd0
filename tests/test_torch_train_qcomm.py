"""The paper's quantized gradient reduce in repro_torch's train step
(``make_train_step(qcomm_bits=8)``): 2 spawned gloo ranks on the CPU, each
on its half of the batch, every gradient leaf summed with ``comm.q_psum``,
against exact training in one process — to the criteria of the
reference's ``tests/test_qcomm.py`` (reduced gemma2-2b, batch (8, 32),
labels = tokens, peak lr 1e-3, warmup 2, 12-step schedule, 8 steps): the
exact run falls by 0.5, the first quantized loss within rel 1e-3 of the
exact one (the same weights: the ranks' mean of their halves' losses),
the last within 0.15.  Both ranks hold the same params bit for bit (the
reduce hands every rank the same sum).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import mesh_pool, train_qcomm  # noqa: E402

pool = mesh_pool(2)


@pytest.fixture(scope="module")
def traces(pool):
    exact = train_qcomm("gemma2-2b", 0)
    q8 = pool.run(train_qcomm, "gemma2-2b", 8, world=2)
    return exact, q8


def test_exact_reduction_trains(traces):
    exact, _ = traces
    assert exact["losses"][-1] < exact["losses"][0] - 0.5, exact["losses"]


def test_q8_matches_exact_training(traces):
    exact, (r0, r1) = traces
    assert r0["losses"][0] == pytest.approx(exact["losses"][0], rel=1e-3)
    assert abs(r0["losses"][-1] - exact["losses"][-1]) < 0.15, (r0["losses"], exact["losses"])
    assert r0["losses"] != exact["losses"], "the quantized reduce changed nothing"


def test_q8_ranks_hold_the_same_params(traces):
    _, (r0, r1) = traces
    assert r0["losses"] == r1["losses"]
    np.testing.assert_array_equal(r0["digest"], r1["digest"])
