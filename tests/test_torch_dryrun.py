"""The sharding hooks on real shards, and the dry run's entry point.

A reduced dense arch (gemma-7b) and a reduced MoE arch (qwen2-moe-a2.7b,
the expert-parallel dispatch) run their float32 forward on 4 spawned gloo
ranks as a (2, 2) ("data", "model") mesh under the single-pod rules —
every parameter a DTensor placed by ``tree_param_specs``, the tokens split
by rows (``tests/_torch_mesh.py::sharded_forward``) — and must equal the
forward in one process within 1e-5 of the logits' scale: a wrong
``constrain``, head split, gathered gate or expert offset shows here,
where a fake group computes nothing.  The MoE runs at a capacity factor
with no dropped choice: capacity is per shard of the batch, in the
reference's expert-parallel branch as here, so a sharded batch drops other
choices than one device does by design.

``python -m repro_torch.launch.dryrun --arch xlstm-125m --shape
long_500k``, the reference's own CLI test combo, exits 0 with ``dom=``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import mesh_pool, sharded_forward  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import forward, init_model  # noqa: E402

pool = mesh_pool(4)
CASES = {"gemma-7b": {}, "qwen2-moe-a2.7b": {"capacity_factor": 2.0}}
TOL = 1e-5


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_forward_equals_one_process(pool, arch):
    import dataclasses

    outs = pool.run(sharded_forward, arch, CASES[arch], world=4)
    cfg = dataclasses.replace(get_config(arch).reduced(), **CASES[arch])
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))
    with torch.no_grad():
        want, aux = forward(init_model(cfg, seed=0, device="cpu"), cfg, {"tokens": toks},
                            dtype=torch.float32)
    want = want.numpy()
    scale = float(np.abs(want).max())
    for r in outs:
        assert r["sharded"]
        np.testing.assert_allclose(r["logits"], want, rtol=0, atol=TOL * scale)
        for k, v in aux.items():
            np.testing.assert_allclose(r["aux"][k], v.numpy(), rtol=0,
                                       atol=TOL * abs(float(v)) + 1e-7)
    np.testing.assert_array_equal(outs[0]["logits"], outs[-1]["logits"])
    if cfg.family == "moe":
        assert float(aux["drop_frac"]) == 0.0


def test_dryrun_cli_single_combo():
    """The dry-run entry point itself, on the cheapest real combo."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "xlstm-125m",
         "--shape", "long_500k"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    assert "dom=" in out.stdout
    assert "0 failures" in out.stdout
