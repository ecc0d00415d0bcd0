"""repro_torch's training system end to end on the CPU, against the
reference where the two can meet: the token stream bit for bit, tree
checkpoints restored across the packages bit for bit (both ways), the
reference's own jitted ``make_train_step`` against the port's, a trained
reduced gemma2 decoded by both in lockstep, and the reference's system
criteria on the port: microbatching (``tests/test_archs.py``: params
within 5e-3 of the unbatched step's), a falling loss over 25 steps
(``tests/test_system.py``), the training CLI and the LM-to-GP-head
example.

Limits: the 3-step loss trace and grad norms within ``TRACE_TOL`` (2.5e-2
relative, the per-arch files' limit: Adam turns a gradient that rounding
alone separates into a full +-lr step); lr equal to 1e-7; decode as
``tests/_torch_decode.py`` holds it (``analysis/lockstep.py``, float32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import _torch_decode  # noqa: E402
from _torch_train import TRACE_TOL, batch_np, params_np  # noqa: E402
from repro_torch.analysis.trainstep import rel_err  # noqa: E402

from repro.checkpoint import latest_step as ref_latest_step  # noqa: E402
from repro.checkpoint import restore_checkpoint as ref_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import lm_batch_stream as ref_stream  # noqa: E402
from repro.models import make_train_step as ref_make_train_step  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro_torch.analysis import lockstep as LS  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_batch_stream  # noqa: E402
from repro_torch.models import (  # noqa: E402
    cast_compute, init_decode_state, init_train_state, make_decode_step, make_train_step,
    params_from_numpy,
)
from repro_torch.models.weights import _map  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402


def _np_tree(tree):
    return _map(lambda _, t: t.detach().cpu().numpy(), tree)


def test_lm_batch_stream_is_the_reference_bitwise():
    ref = ref_stream(512, 4, 48, seed=3)
    got = lm_batch_stream(512, 4, 48, seed=3, device="cpu")
    for _ in range(3):
        r, g = next(ref), next(got)
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32 and g[k].shape == (4, 48)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))


def _state(cfg, seed):
    params, opt = init_train_state(cfg, seed=seed, device="cpu")
    with torch.no_grad():  # moments that are not zero
        _map(lambda _, a: a.uniform_(0.0, 1e-3), opt.m)
        _map(lambda _, a: a.uniform_(0.0, 1e-6), opt.v)
    return {"params": params, "opt": opt}


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    cfg = get_config("xlstm-125m").reduced()
    tree = _state(cfg, 2)
    save_checkpoint(str(tmp_path), 7, tree)
    assert ref_latest_step(str(tmp_path)) == latest_step(str(tmp_path)) == 7
    p_np = _np_tree(tree["params"])
    like = {"params": p_np, "opt": ref_adamw_init(p_np)}
    back = ref_restore(str(tmp_path), 7, like)
    assert int(back["opt"].step) == 0
    for want, got in ((p_np, back["params"]), (_np_tree(tree["opt"].m), back["opt"].m),
                      (_np_tree(tree["opt"].v), back["opt"].v)):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    cfg = ref_get_config("gemma2-2b").reduced()
    from repro.models.steps import init_train_state as ref_init_train_state

    params, opt = jax.jit(ref_init_train_state, static_argnums=1)(jax.random.PRNGKey(2), cfg)
    ref_save(str(tmp_path), 5, {"params": params, "opt": opt})
    port = _state(get_config("gemma2-2b").reduced(), 0)
    back = restore_checkpoint(str(tmp_path), 5, port)
    assert type(back["opt"]) is type(port["opt"]) and back["opt"].step.dtype == torch.int32
    for want, got in ((params, back["params"]), (opt.m, back["opt"].m), (opt.v, back["opt"].v)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        for path, a in flat_w:
            node = got
            for k in path:
                node = node[k.key]
            assert node.device.type == "cpu" and node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), np.asarray(a))


def test_port_checkpoint_roundtrip_keeps_devices_and_bits(tmp_path):
    cfg = get_config("xlstm-125m").reduced()
    tree = _state(cfg, 1)
    path = save_checkpoint(str(tmp_path), 3, tree)
    assert os.path.basename(path) == "ckpt_00000003.npz"
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    back = restore_checkpoint(str(tmp_path), 3, tree)
    for a, b in zip(jax.tree.leaves(_np_tree(tree["params"])),
                    jax.tree.leaves(_np_tree(back["params"]))):
        np.testing.assert_array_equal(a, b)
    assert int(back["opt"].step) == 0 and back["opt"].step.dtype == torch.int32


def test_reference_train_step_matches_the_port():
    """The reference's own jitted ``make_train_step`` against the port's, 3
    steps from the same weights on the same batch (float32 in both)."""
    arch = "gemma2-2b"
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    p_np, b_np = params_np(cfg), batch_np(cfg)
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=6)
    with _torch_decode.compute_dtype("float32"):
        step = jax.jit(ref_make_train_step(ref_cfg, **kw))
        p = jax.tree.map(jnp.asarray, p_np)
        o, want = ref_adamw_init(p), []
        for _ in range(3):
            p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b_np.items()})
            want.append({k: float(v) for k, v in m.items()})
    port_step = make_train_step(cfg, dtype=torch.float32, **kw)
    pp = params_from_numpy(p_np, "cpu")
    po, got = adamw_init(pp), []
    batch = {k: torch.from_numpy(v) for k, v in b_np.items()}
    for _ in range(3):
        pp, po, m = port_step(pp, po, batch)
        got.append({k: float(v) for k, v in m.items()})
    assert int(po.step) == int(o.step) == 3
    for w, g in zip(want, got):
        assert set(w) == set(g)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7, abs=1e-12)
        for k in ("loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=TRACE_TOL)


def test_microbatched_step_matches_unbatched():
    cfg = get_config("xlstm-125m").reduced()
    halves = batch_np(cfg, seed=4), batch_np(cfg, seed=5)
    b_np = {k: np.concatenate([halves[0][k], halves[1][k]]) for k in halves[0]}  # B 4
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b_np.items()}
    kw = dict(peak_lr=1e-3, warmup=0)  # a step that moves the params (warmup 100: lr 0)
    out = {}
    for mb in (1, 2):
        params, opt = init_train_state(cfg, device="cpu")
        out[mb] = make_train_step(cfg, microbatches=mb, **kw)(params, opt, batch)
    d = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(_np_tree(out[1][0])), jax.tree.leaves(_np_tree(out[2][0]))))
    assert d < 5e-3, f"microbatched step diverged from the unbatched one: {d}"
    # the mean of the two halves' gradients: the same global norm up to fp32 sums
    gn1, gn2 = float(out[1][2]["grad_norm"]), float(out[2][2]["grad_norm"])
    assert gn2 == pytest.approx(gn1, rel=1e-5)
    # the metrics are the last microbatch's, as the reference's scan carry leaves them
    params, opt = init_train_state(cfg, device="cpu")
    last = make_train_step(cfg, **kw)(params, opt, {k: v[2:] for k, v in batch.items()})[2]
    assert float(out[2][2]["loss"]) == pytest.approx(float(last["loss"]), rel=1e-6)
    assert float(out[1][2]["loss"]) != pytest.approx(float(last["loss"]), rel=1e-6)


def test_lm_training_loss_decreases_end_to_end():
    cfg = get_config("xlstm-125m").reduced()
    params, opt = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, peak_lr=1e-3, warmup=5, total_steps=40)
    stream = lm_batch_stream(cfg.vocab_size, batch=4, seq=64, seed=1, device="cpu")
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, next(stream))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])


def test_decode_after_training_matches_the_reference():
    """A reduced gemma2 trained 3 steps by the port, then decoded greedily
    by ``make_decode_step`` and teacher-forced through both packages'
    decode steps in lockstep (float32)."""
    cfg = get_config("gemma2-2b").reduced()
    params, opt = init_train_state(cfg, seed=1, device="cpu")
    step = make_train_step(cfg, peak_lr=1e-3, warmup=1, total_steps=3)
    stream = lm_batch_stream(cfg.vocab_size, 2, 32, seed=2, device="cpu")
    for _ in range(3):
        params, opt, _ = step(params, opt, next(stream))
    dec = make_decode_step(cfg)
    served = cast_compute(params)
    state = init_decode_state(cfg, 2, 32, "cpu")
    tok, toks = torch.zeros((2, 1), dtype=torch.int32), []
    with torch.no_grad():
        for pos in range(8):
            tok, state = dec(served, state, tok, torch.tensor(pos, dtype=torch.int32))
            toks.append(tok)
    toks = torch.cat(toks, 1).numpy()
    assert toks.shape == (2, 8) and ((toks >= 0) & (toks < cfg.vocab_size)).all()
    trained = jax.tree.map(jnp.asarray, _np_tree(params))
    rep, _ = _torch_decode.run("gemma2-2b", "float32", steps=12, ref_params=trained)
    assert not LS.faults(rep), LS.faults(rep)
    assert rep["greedy_clear"] > 0


def test_train_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    out = main(["--arch", "xlstm-125m", "--reduce", "--steps", "6", "--batch", "2", "--seq",
                "32", "--workdir", str(tmp_path), "--ckpt-every", "6", "--log-every", "2",
                "--device", "cpu", "--mesh", "16x16", "--qcomm-bits", "8"])
    text = capsys.readouterr().out
    assert "arch=xlstm-125m family=ssm" in text and "final checkpoint" in text
    lines = [ln for ln in text.splitlines() if ln.startswith("step ")]
    assert len(lines) == 4 and all("loss" in ln and "gnorm" in ln and "s/step" in ln
                                   for ln in lines)
    assert latest_step(str(tmp_path)) == 6
    with open(tmp_path / "metrics.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "step,loss,grad_norm,lr,sec_per_step" and len(rows) == 5
    assert [int(r.split(",")[0]) for r in rows[1:]] == [1, 2, 4, 6]
    back = restore_checkpoint(str(tmp_path), 6, out["params"])
    for a, b in zip(jax.tree.leaves(_np_tree(out["params"])), jax.tree.leaves(_np_tree(back))):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(v) for row in out["logged"] for v in row)


def test_gp_head_example_on_the_cpu(capsys):
    from repro_torch.examples.train_lm_gp_head import main

    out = main(["--steps", "3", "--batch", "2", "--seq", "32", "--feature-batches", "10",
                "--gp-steps", "5", "--bits", "16", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "stage 1" in text and "stage 2" in text and "quantized-gram R= 16" in text
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["n_features"] == 20
    assert set(out["smse"]) == {"full", "rbcm", 16} and all(np.isfinite(list(
        out["smse"].values())))
    assert out["wire_bits"][16] > 0


@pytest.mark.parametrize("arch", ["gemma2-2b", "xlstm-125m"])
def test_prefill_step_matches_reference(arch):
    """``make_prefill_step``'s last-position logits against the reference's,
    both in their default compute dtype (bf16), within 16 bf16 ulps of
    scale (``lockstep.BF16_TOL``, as decode's logits are held)."""
    from repro.models import make_prefill_step as ref_make_prefill_step
    from repro_torch.models import make_prefill_step

    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    p_np, b_np = params_np(cfg), batch_np(cfg)
    want = jax.jit(ref_make_prefill_step(ref_cfg))(
        jax.tree.map(jnp.asarray, p_np), {k: jnp.asarray(v) for k, v in b_np.items()})
    got = make_prefill_step(cfg)(params_from_numpy(p_np, "cpu"),
                                 {k: torch.from_numpy(v) for k, v in b_np.items()})
    assert got.shape == want.shape == (2, cfg.vocab_size) and got.dtype == torch.bfloat16
    assert rel_err(np.asarray(want.astype(jnp.float32)), got.float().numpy()) <= LS.BF16_TOL
