"""repro_torch's training path against the reference's for whisper-medium (the
encoder-decoder family: a bidirectional encoder over the stub frame
embeddings, causal decoder self-attention, cross-attention through
``attention_apply``'s ``x_kv``): the same weights and batch through both
packages on the CPU, in float32 and in bf16 — forward logits and aux,
``loss_fn``'s loss and every gradient leaf at step 0, an 8-step loss trace —
and the port's remat (per layer, and per group of layers with
``remat_blocks``) against no remat. The runs, their limits and the readings
the limits were set from: ``tests/_torch_train.py``; remat recomputes the
same fp32 operations, so its gradients are held within 1e-6 of each leaf's
scale (the accumulation order of a leaf used twice may change).
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_train import (  # noqa: E402
    BF16_TRACE, F32_LIMITS, HYBRID_F32_LIMITS, faults, remat_grads, report, sides_of,
)
from repro_torch.analysis.trainstep import rel_err  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

ARCHS = ['whisper-medium']


def _limits(arch):
    return HYBRID_F32_LIMITS if get_config(arch).family == "hybrid" else F32_LIMITS


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_step_matches_reference(arch):
    rep = report(sides_of(arch))
    lim = _limits(arch)
    for q in ("logits", "loss", "aux", "grads"):
        assert rep["f32"][q] <= lim[q], (q, rep["f32"])
    assert rep["f32"]["finite"]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_tracks_the_reference(arch):
    rep = report(sides_of(arch))
    assert rep["bf16"]["finite"]
    assert not [f for f in faults(arch, rep) if f.startswith("bf16")], faults(arch, rep)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_trace_matches_reference(arch):
    sides, rep = sides_of(arch), report(sides_of(arch))
    assert rep["f32"]["trace"] <= _limits(arch)["trace"], rep["f32"]
    assert rep["port_bf16_vs_f32"]["trace"] <= BF16_TRACE
    trace = sides["port", "float32"]["trace"]
    assert len(trace) == 8 and trace[-1] < trace[0], trace


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    plain, plain_saved = remat_grads(arch, remat=False)
    for kw in (dict(remat=True), dict(remat=True, remat_blocks=1)):
        got, saved = remat_grads(arch, **kw)
        assert saved < plain_saved, (kw, saved, plain_saved)  # activations recomputed
        assert set(got) == set(plain)
        for k in plain:
            assert rel_err(plain[k], got[k]) <= 1e-6, (kw, k)
