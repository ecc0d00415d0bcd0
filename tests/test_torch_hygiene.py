"""repro_torch stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DGPConfig, DistributedGP  # noqa: E402
from repro_torch.core.fleet import ArtifactStore  # noqa: E402
from repro_torch.core.protocols import base  # noqa: E402
from repro_torch.launch.fleet import FleetServer, main as fleet_main  # noqa: E402

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_import_in_the_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    assert PKG / "launch" / "fleet.py" in files and PKG / "core" / "fleet.py" in files
    assert PKG / "faults.py" in files and PKG / "core" / "rate_distortion.py" in files
    assert PKG / "launch" / "serve_gp.py" in files and PKG / "core" / "distributed_gp.py" in files
    assert {PKG / "analysis" / f for f in ("contracts.py", "op_walk.py", "lint.py",
                                                "lockstep.py", "trainstep.py")} <= set(files)
    assert PKG / "examples" / "quickstart.py" in files
    models = {"config", "layers", "moe", "ssm", "backbone", "decode", "steps", "weights"}
    assert {PKG / "models" / f"{m}.py" for m in models} <= set(files)
    assert {PKG / "launch" / "serve.py", PKG / "examples" / "serve_decode.py",
            PKG / "configs" / "legacy" / "gemma2_2b.py"} <= set(files)
    assert {PKG / "optim" / f for f in ("__init__.py", "adamw.py", "schedules.py")} <= set(files)
    assert {PKG / "launch" / "train.py", PKG / "examples" / "train_lm_gp_head.py",
            PKG / "checkpoint" / "ckpt.py", PKG / "data" / "synthetic.py"} <= set(files)
    assert len(list((PKG / "configs" / "legacy").glob("*.py"))) == 11
    bad = [
        f"{f.relative_to(PKG)}: {name}"
        for f in files for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, bad


def test_chip_smoke_imports_no_jax_or_repro():
    bad = [name for name in _imports(PKG.parents[1] / "chip_smoke.py")
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_cpu_fit_leaves_no_jax_or_repro_module_loaded():
    code = """
import sys
import numpy as np
from repro_torch.core import DGPConfig, DistributedGP
from repro_torch.core.fleet import FleetStack
from repro_torch.faults import corrupt_words, drop_machine
import repro_torch.launch.fleet
import repro_torch.launch.serve_gp, repro_torch.core.distributed_gp
import repro_torch.examples.quickstart, repro_torch.examples.distributed_gp_sarcos
import repro_torch.launch.serve, repro_torch.examples.serve_decode
from repro_torch.configs import get_config
from repro_torch.models import cast_compute, decode_step, init_decode_state, init_model
import repro_torch.optim, repro_torch.launch.train, repro_torch.examples.train_lm_gp_head
from repro_torch.models import init_train_state, make_train_step
from repro_torch.data import lm_batch_stream
cfg = get_config("gemma2-2b").reduced()
p, o = init_train_state(cfg, device="cpu")
p, o, m = make_train_step(cfg)(p, o, next(lm_batch_stream(cfg.vocab_size, 2, 8, device="cpu")))
assert bool(m["loss"] > 0) and int(o.step) == 1
state = init_decode_state(cfg, 1, 4, "cpu")
import torch
logits, _ = decode_step(cast_compute(init_model(cfg, device="cpu")), cfg, state,
                        torch.zeros((1, 1), dtype=torch.int32), torch.tensor(0, dtype=torch.int32))
assert logits.shape == (1, 1, cfg.vocab_size)
from repro_torch.analysis import check_contracts, lint
rng = np.random.default_rng(0)
X = rng.normal(size=(48, 4)).astype(np.float32)
y = X[:, 0].copy()
for protocol in ("center", "broadcast", "poe"):
    est = DistributedGP(DGPConfig(protocol=protocol, gram_backend="pallas", steps=2),
                        device="cpu")
    art = est.fit(X, y, m=4)
    mu, var = est.predict(art, X[:5])
    assert mu.shape == (5,) and bool((var > 0).all())
    assert check_contracts(art, X[:5]).ok
    mu, var = FleetStack({0: art, 1: art}).predict([1, 0], np.stack([X[:5], X[5:10]]))
    assert mu.shape == (2, 5) and bool((var > 0).all())
    plan = drop_machine(2) | corrupt_words(0.01, seed=1)  # poe: the flips are a no-op
    est = DistributedGP(DGPConfig(protocol=protocol, steps=2, faults=plan), device="cpu")
    assert est.health(est.fit(X, y, m=4)).machines_lost == (2,)
for protocol in ("center", "broadcast"):
    est = DistributedGP(DGPConfig(protocol=protocol, scheme="vq", steps=2), device="cpu")
    art = est.fit(X, y, m=4)
    assert art.wire_bits > 0 and bool((est.predict(art, X[:5])[1] > 0).all())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DistributedGP()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DistributedGP(DGPConfig(gram_backend="pallas"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        base.fit([], DGPConfig())
    est = DistributedGP(device="cpu")
    assert est.device.type == "cpu"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        base.load_artifact(str(tmp_path))
    store = ArtifactStore(str(tmp_path))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        store.load("0000")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FleetServer(store)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fleet_main(["--tenants", "2", "--requests", "2"])
    cpu_store = ArtifactStore(str(tmp_path), device="cpu")
    assert FleetServer(cpu_store, device="cpu").device.type == "cpu"


def test_decode_serving_raises_without_cuda(monkeypatch):
    from repro_torch.examples.serve_decode import main as example_main
    from repro_torch.launch.serve import main as serve_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_main(["--arch", "xlstm-125m", "--reduce", "--gen", "2", "--prompt-len", "2"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        example_main(["--gen", "2", "--prompt-len", "2"])


def test_training_raises_without_cuda(monkeypatch):
    from repro_torch.examples.train_lm_gp_head import main as example_main
    from repro_torch.launch.train import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_main(["--arch", "xlstm-125m", "--reduce", "--steps", "1"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        example_main(["--steps", "1"])


def test_restore_checkpoint_places_leaves_like_the_tree(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    tree = {"a": {"w": torch.arange(3.0)}, "s": torch.tensor(2, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 1, tree)
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        like = {"a": {"w": torch.zeros(3, device=dev)},
                "s": torch.zeros((), dtype=torch.int32, device=dev)}
        back = restore_checkpoint(str(tmp_path), 1, like)
        assert back["a"]["w"].device.type == back["s"].device.type == dev
        assert torch.equal(back["a"]["w"].cpu(), tree["a"]["w"]) and int(back["s"]) == 2


def _model_call(name, ckpt):
    """A models entry point that places tensors, as f(**device) -> a tensor it made."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import lm_batch_stream
    from repro_torch.models import (
        init_decode_state, init_model, init_train_state, params_from_numpy, state_from_numpy,
    )
    from repro_torch.models.layers import Init

    cfg = get_config("xlstm-125m").reduced()
    leaf = np.ones(2, np.float32)
    save_checkpoint(ckpt, 0, {"ln_f": {"scale": np.ones(cfg.d_model, np.float32)}})

    def restore(**kw):  # the like tree made where the caller says: the leaf lands there
        like = {"ln_f": init_model(cfg, **kw)["ln_f"]}
        return restore_checkpoint(ckpt, 0, like)["ln_f"]["scale"]

    return {
        "init_train_state": lambda **kw: init_train_state(cfg, **kw)[1].m["ln_f"]["scale"],
        "lm_batch_stream": lambda **kw: next(lm_batch_stream(cfg.vocab_size, 1, 4,
                                                             **kw))["tokens"],
        "restore_checkpoint": restore,
        "init_model": lambda **kw: init_model(cfg, **kw)["ln_f"]["scale"],
        "init_decode_state": lambda **kw: init_decode_state(cfg, 1, 2, **kw)["pairs"]["slstm_c"],
        "params_from_numpy": lambda **kw: params_from_numpy({"w": leaf}, **kw)["w"],
        "state_from_numpy": lambda **kw: state_from_numpy({"a": {"k": leaf}}, **kw)["a"]["k"],
        "Init": lambda **kw: Init(0, **kw).normal((2,)),
    }[name]


@pytest.mark.parametrize("name", ["init_model", "init_decode_state", "params_from_numpy",
                                  "state_from_numpy", "Init", "init_train_state",
                                  "lm_batch_stream", "restore_checkpoint"])
def test_model_tensors_land_on_the_card_by_default(name, monkeypatch, tmp_path):
    call = _model_call(name, str(tmp_path))
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
