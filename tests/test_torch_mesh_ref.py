"""The port's ``impl="mesh"`` (spawned gloo ranks) against the reference's
mesh (``shard_map`` over the conftest's 8 host devices, run live in this
process) on identical numpy parts, from the same starting hyperparameters.

Tolerances and why:
* ledgers, lengths and rates: integer-equal (they depend only on the
  eigenvalues and the row counts; the words cannot match, the eigenvector
  signs differ — tests/test_torch_comm.py holds the words and CRCs given
  the reference's scheme state);
* the wire's reconstructions: 1e-4 of the data scale, as the batched
  parity tests hold them;
* answers after six Adam steps: 2e-4 of the output's scale, as
  tests/test_torch_center.py and tests/test_torch_broadcast.py hold
  trained fits;
* a checkpoint written by one package and served by the other: 1e-5 of
  scale (the same factors, two packages' matmuls).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import fit_predict, fit_stream, mesh_pool, quantize  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro.core.protocols.center import quantize_to_center as ref_quantize  # noqa: E402
from repro_torch.core import DistributedGP  # noqa: E402

pool = mesh_pool(5)
START = (0.2, -0.3, -1.5)


def _parts(lengths, d, seed):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, 2))
    parts = []
    for n_j in lengths:
        X = rng.normal(size=(n_j, d)).astype(np.float32)
        y = (np.sin(X @ W[:, 0]) + 0.4 * (X @ W[:, 1])
             + 0.05 * rng.normal(size=n_j)).astype(np.float32)
        parts.append((X, y))
    return parts, rng.normal(size=(24, d)).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()))


def _ledgers(x):
    get = (lambda k: x[k]) if isinstance(x, dict) else (lambda k: getattr(x, k))
    return tuple(int(get(k)) for k in ("wire_bits", "payload_bits", "integrity_bits"))


def test_quantize_to_center_mesh_against_reference(pool):
    """(The port's mesh wire against its batched and host wires at more
    settings: tests/test_torch_mesh.py.)"""
    lengths, d, bits = (37, 41, 29, 43), 6, 16
    parts, _ = _parts(lengths, d, seed=len(lengths) + bits)
    o = pool.run(quantize, parts, bits, world=len(parts))[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rX, ry, rw, rK, rsq = ref_quantize(parts, bits, impl="mesh")
    assert (o["wire_bits"], o["n_center"]) == (int(rw), int(rK))
    np.testing.assert_array_equal(o["y"], np.asarray(ry))
    _close(o["X"], rX, 1e-4)
    _close(o["sq"], rsq, 1e-6)


PROTOCOLS = {
    "center": dict(protocol="center", bits_per_sample=20),
    "broadcast": dict(protocol="broadcast", fusion="kl", bits_per_sample=24),
    "poe": dict(protocol="poe", fusion="rbcm", bits_per_sample=0),
}
DOWN = np.array([1, 1, 0, 1], np.float32)
BATCHES = ((1, 6), (3, 5))


@pytest.fixture(scope="module")
def runs(pool, tmp_path_factory):
    """Per protocol: the reference's mesh fit (answers, degraded answers,
    a checkpoint; for broadcast, whose updates cross the wire, the ledgers
    after a two-batch stream) and the port's, on the same parts."""
    parts, Xq = _parts((31, 44, 27, 38), 6, seed=5)
    rng = np.random.default_rng(6)
    batches = [(j, rng.normal(size=(n, 6)).astype(np.float32),
                rng.normal(size=n).astype(np.float32)) for j, n in BATCHES]
    out = {}
    for name, cfg in PROTOCOLS.items():
        ref_dir = str(tmp_path_factory.mktemp(f"ref_{name}"))
        port_dir = str(tmp_path_factory.mktemp(f"port_{name}"))
        rcfg = RefConfig(impl="mesh", steps=6, **cfg)
        est = RefGP(rcfg)
        art = est.fit(parts=parts, params=RefParams(*(jnp.float32(v) for v in START)))
        mu, var = est.predict(art, Xq)
        ref = {"art": art, "mu": np.asarray(mu), "var": np.asarray(var), "dir": ref_dir}
        if name != "center":
            ref["mu_d"], ref["var_d"] = (np.asarray(a) for a in est.predict(art, Xq,
                                                                             available=DOWN))
        est.save(art, ref_dir)
        port = pool.run(fit_predict, dict(steps=6, **cfg), parts, Xq, START,
                        None if name == "center" else DOWN, port_dir, world=4)[0]
        if name == "broadcast":
            streamed = art
            for j, Xn, yn in batches:
                streamed = est.update(streamed, Xn, yn, machine=j)
            ref["streamed"] = streamed
            port["stream"] = pool.run(fit_stream, dict(steps=6, **cfg), parts, Xq, batches,
                                      START, world=4)[0]
        port["dir"] = port_dir
        out[name] = (ref, port, Xq)
    return out


@pytest.mark.parametrize("name", list(PROTOCOLS))
def test_mesh_integers_equal_the_reference_mesh(runs, name):
    ref, port, _ = runs[name]
    art = ref["art"]
    assert _ledgers(port) == _ledgers(art)
    assert tuple(port["lengths"]) == tuple(art.lengths)
    if art.wire is not None:
        np.testing.assert_array_equal(port["rates"], np.asarray(art.wire.rates))
        _close(port["decoded"], np.asarray(art.wire.decoded), 1e-4)
    if "streamed" in ref:
        assert _ledgers(port["stream"]["steps"][-1]) == _ledgers(ref["streamed"])
        assert tuple(port["stream"]["lengths"]) == tuple(ref["streamed"].lengths)


@pytest.mark.parametrize("name", list(PROTOCOLS))
def test_mesh_answers_within_tolerance_of_the_reference_mesh(runs, name):
    ref, port, _ = runs[name]
    for k in ("mu", "var", "mu_d", "var_d"):
        if k in ref:
            _close(port[k], ref[k], 2e-4)


@pytest.mark.parametrize("name", list(PROTOCOLS))
def test_mesh_checkpoints_load_across_packages(runs, name):
    """The port's mesh checkpoint served by the reference, and the
    reference's mesh checkpoint served by the port: both restore
    single-process artifacts with the writer's integers and answers."""
    ref, port, Xq = runs[name]
    rest = RefGP(RefConfig(**PROTOCOLS[name]))
    theirs = rest.load(port["dir"])
    assert _ledgers(theirs) == _ledgers(port) and theirs.impl == "batched"
    mu, var = rest.predict(theirs, Xq)
    _close(np.asarray(mu), port["mu"], 1e-5)
    _close(np.asarray(var), port["var"], 1e-5)
    ours = DistributedGP(device="cpu").load(ref["dir"])
    assert _ledgers(ours) == _ledgers(ref["art"]) and ours.impl == "batched"
    mu, var = ours.predict(Xq)
    _close(mu.numpy(), ref["mu"], 1e-5)
    _close(var.numpy(), ref["var"], 1e-5)
