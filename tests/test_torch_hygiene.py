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
    assert {PKG / "analysis" / f for f in ("contracts.py", "op_walk.py", "lint.py")} <= set(files)
    assert PKG / "examples" / "quickstart.py" in files
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
