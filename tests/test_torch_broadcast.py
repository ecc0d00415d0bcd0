"""The §5.2 broadcast protocol and the zero-rate poe baseline end to end:
repro_torch against the reference.

Both packages fit the SAME ``parts`` (built in numpy from a seed) from the
SAME starting hyperparameters, for ``gram_backend="xla"`` and
``"pallas"``.  The reference's pallas fits and serves run the Pallas
bodies in interpret mode (``REPRO_FORCE_PALLAS=1``): qgram_packed and gram
at fit time, gram and the fused epilogue on every request.  The port's run
the kernels' plain versions (CPU tensors).

Tolerances and why:
* ledgers and rates: integer-equal (they depend only on eigenvalues and
  lengths; codes and words cannot match, eigenvector signs differ);
* X̂: 1e-4 relative to the data scale, as for the center protocol;
* predictions at steps=0: 1e-4 relative to the output's scale — the views'
  grams differ only through X̂;
* trained params and predictions at steps=20, also degraded
  (``available=``) and for poe: 2e-4 — twenty Adam steps carry the small
  differences forward;
* fused vs unfused serving inside the port: 2e-4 absolute, as the
  reference's own test holds them (tests/test_kernel_runtime.py): the KL
  finalize subtracts mu^2 from the summed second moments, and the
  precision rows sum 1/s2 terms, so the two routes round differently;
* cross-package checkpoints: 1e-5 — the same factors, served by the two
  packages' matmuls.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import fit_predict  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP, GPParams  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402


M, D, N_PER = 5, 5, 14  # 70 training points over 5 machines
START = (0.2, -0.3, -1.5)  # log_a, log_b, log_noise: the shared start
DOWN = np.array([1, 1, 0, 1, 1], np.float32)  # machine 2 lost at serve time


def _data():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    X = (rng.normal(size=(M * N_PER, D)) @ A.T).astype(np.float32)
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
         + 0.05 * rng.normal(size=X.shape[0])).astype(np.float32)
    Xq = (rng.normal(size=(23, D)) @ A.T).astype(np.float32)
    # ragged shards: machine 4 holds two rows fewer
    parts = [(X[j::M], y[j::M]) for j in range(M)]
    parts[4] = (parts[4][0][:-2], parts[4][1][:-2])
    return parts, Xq


PARTS, XQ = _data()


class _ForcePallas:
    """REPRO_FORCE_PALLAS=1 around the reference's pallas runs: its kernels
    run in interpret mode instead of the XLA fallback."""

    def __init__(self, backend):
        self.on = backend == "pallas"

    def __enter__(self):
        self.old = os.environ.get("REPRO_FORCE_PALLAS")
        if self.on:
            os.environ["REPRO_FORCE_PALLAS"] = "1"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("REPRO_FORCE_PALLAS", None)
        else:
            os.environ["REPRO_FORCE_PALLAS"] = self.old


def _ref_run(backend, steps, **cfg):
    params = RefParams(*(jnp.float32(v) for v in START))
    rcfg = RefConfig(gram_backend=backend, steps=steps, **cfg)
    with _ForcePallas(backend):
        art = RefGP(rcfg).fit(parts=PARTS, params=params)
        mu, var = RefGP(rcfg).predict(art, XQ)
        mu_d, var_d = RefGP(rcfg).predict(art, XQ, available=DOWN)
    return art, [np.asarray(a) for a in (mu, var, mu_d, var_d)]


def _port_run(backend, steps, **cfg):
    params = GPParams(*(torch.tensor(v, dtype=torch.float32) for v in START))
    est = DistributedGP(DGPConfig(gram_backend=backend, steps=steps, **cfg), device="cpu")
    art = est.fit(parts=PARTS, params=params)
    mu, var = est.predict(art, XQ)
    mu_d, var_d = est.predict(art, XQ, available=DOWN)
    return art, [a.numpy() for a in (mu, var, mu_d, var_d)]


BROADCAST = dict(protocol="broadcast", fusion="kl")
BACKENDS = ["xla", "pallas"]


@pytest.fixture(scope="module")
def fits():
    out = {}
    for backend in BACKENDS:
        for steps in (0, 20):
            out[backend, steps] = (_ref_run(backend, steps, **BROADCAST),
                                   _port_run(backend, steps, **BROADCAST))
    return out


@pytest.fixture(scope="module")
def poe_fits():
    out = {}
    for method in ("bcm", "rbcm"):
        for backend in BACKENDS:
            cfg = dict(protocol="poe", fusion=method)
            out[method, backend] = (_ref_run(backend, 20, **cfg),
                                    _port_run(backend, 20, **cfg))
    return out


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_ledgers_rates_and_layout(fits, backend):
    (ref, _), (art, _) = fits[backend, 0]
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits)
    assert art.wire_bits > 0 and art.lengths == ref.lengths
    np.testing.assert_array_equal(art.wire.rates.numpy(), np.asarray(ref.wire.rates))
    _close(art.wire.decoded.numpy(), ref.wire.decoded, 1e-4)
    assert sorted(art.factors) == sorted(ref.factors)
    assert sorted(art.data) == sorted(ref.data)
    for k in art.factors:
        assert tuple(art.factors[k].shape) == tuple(ref.factors[k].shape), k
    assert tuple(art.y.shape) == tuple(ref.y.shape)
    assert (art.fuse, art.gram_mode, art.n_center, art.block_order) == (
        ref.fuse, ref.gram_mode, ref.n_center, ref.block_order)


@pytest.mark.parametrize("backend", BACKENDS)
def test_predictions_untrained_tight(fits, backend):
    (_, want), (_, got) = fits[backend, 0]
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_trained_params_and_predictions(fits, backend):
    (ref, want), (art, got) = fits[backend, 20]
    _close(np.array([float(a) for a in art.params]),
           np.array([float(a) for a in ref.params]), 2e-4)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, 2e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_available_with_one_machine_down(fits, backend):
    (_, want), (_, got) = fits[backend, 20]
    for g, w in zip(got[2:], want[2:]):
        _close(g, w, 2e-4)
    # losing a machine changes the answer and never shrinks the KL variance
    assert not np.allclose(got[0], got[2])
    assert np.all(got[3] >= got[1] * (1 - 1e-5))


def test_backends_agree_in_the_port(fits):
    (_, (_, got_x)), (_, (_, got_p)) = fits["xla", 20], fits["pallas", 20]
    for g, w in zip(got_p, got_x):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("fuse", ["kl", "poe", "gpoe", "bcm", "rbcm"])
def test_fused_epilogue_equals_unfused(fuse):
    params = GPParams(*(torch.tensor(v, dtype=torch.float32) for v in START))
    cfg = DGPConfig(protocol="broadcast", fusion=fuse, gram_backend="pallas", steps=4,
                    bits_per_sample=8, serve_epilogue="fused")
    est_f = DistributedGP(cfg, device="cpu")
    art_f = est_f.fit(parts=PARTS, params=params)
    assert "Ainv" in art_f.factors and "U" in art_f.factors
    est_u = DistributedGP(dataclasses.replace(cfg, serve_epilogue="unfused"), device="cpu")
    art_u = est_u.fit(parts=PARTS, params=params)
    assert "Ainv" not in art_u.factors
    for avail in (None, DOWN):
        mu_f, s2_f = est_f.predict(art_f, XQ, available=avail)
        mu_u, s2_u = est_u.predict(art_u, XQ, available=avail)
        np.testing.assert_allclose(mu_f.numpy(), mu_u.numpy(), atol=2e-4)
        np.testing.assert_allclose(s2_f.numpy(), s2_u.numpy(), atol=2e-4)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["bcm", "rbcm"])
def test_poe_matches_reference(poe_fits, method, backend):
    (ref, want), (art, got) = poe_fits[method, backend]
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (0, 0, 0)
    assert art.wire is None and ref.wire is None
    assert (art.fuse, art.gram_mode, art.bits_per_sample, art.max_bits) == (
        ref.fuse, ref.gram_mode, ref.bits_per_sample, ref.max_bits) == (
        method, "dense", 0, 0)
    assert tuple(art.y.shape) == tuple(ref.y.shape) and sorted(art.factors) == ["L", "alpha"]
    _close(np.array([float(a) for a in art.params]),
           np.array([float(a) for a in ref.params]), 2e-4)
    for g, w in zip(got, want):  # healthy and with machine 2 down
        _close(g, w, 2e-4)


def _ref_serve(ref, backend):
    with _ForcePallas(backend):
        mu, var = RefGP(RefConfig()).predict(ref, XQ)
        mu_d, var_d = RefGP(RefConfig()).predict(ref, XQ, available=DOWN)
    return [np.asarray(a) for a in (mu, var, mu_d, var_d)]


def _port_serve(est, art):
    return [a.numpy() for a in (*est.predict(art, XQ), *est.predict(art, XQ, available=DOWN))]


CKPT_CASES = [("broadcast", "pallas"), ("broadcast", "xla"), ("poe", "pallas")]


@pytest.mark.parametrize("protocol,backend", CKPT_CASES)
def test_reference_checkpoint_serves_in_port(fits, poe_fits, protocol, backend, tmp_path):
    (ref, _), _ = fits[backend, 20] if protocol == "broadcast" else poe_fits["rbcm", backend]
    want = _ref_serve(ref, backend)
    RefGP(RefConfig()).save(ref, str(tmp_path))
    est = DistributedGP(device="cpu")
    art = est.load(str(tmp_path))
    assert art.protocol == protocol and art.config.gram_backend == backend
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits)
    for g, w in zip(_port_serve(est, art), want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("protocol,backend", CKPT_CASES)
def test_port_checkpoint_serves_in_reference(fits, poe_fits, protocol, backend, tmp_path):
    _, (art, _) = fits[backend, 20] if protocol == "broadcast" else poe_fits["rbcm", backend]
    est = DistributedGP(device="cpu")
    got = _port_serve(est, art)
    est.save(art, str(tmp_path))
    ref = RefGP.load(str(tmp_path))
    assert ref.protocol == protocol and sorted(ref.data) == sorted(art.data)
    if protocol == "broadcast":
        assert ref.wire.codes.dtype == jnp.uint32
        np.testing.assert_array_equal(
            np.asarray(ref.wire.codes).view(np.int32), art.wire.codes.numpy())
    for g, w in zip(got, _ref_serve(ref, backend)):
        _close(g, w, 1e-5)


def test_port_roundtrip_is_bitwise(fits, tmp_path):
    _, (art, got) = fits["pallas", 20]
    est = DistributedGP(device="cpu")
    est.save(art, str(tmp_path))
    back = est.load(str(tmp_path))
    for g, w in zip(_port_serve(est, back), got):
        np.testing.assert_array_equal(g, w)


def test_cpu_path_launches_no_kernel():
    runtime.reset_launches()
    _port_run("pallas", 1, **BROADCAST)
    _port_run("pallas", 1, protocol="poe", fusion="rbcm")
    counts = runtime.launches()  # every registered family, epilogue_fleet too
    assert {"epilogue", "gram", "qgram_packed"} <= set(counts)
    assert set(counts.values()) == {0}, counts


def test_unported_broadcast_paths_raise_naming_their_slice():
    # every path is ported; on the mesh (one process per machine) broadcast
    # refuses direct views, as the reference's mesh does, and in one
    # process the mesh refuses to run; health() and the vq scheme:
    # tests/test_torch_faults.py, tests/test_torch_vq.py
    est = DistributedGP(DGPConfig(protocol="broadcast", gram_mode="direct"), device="cpu")
    with pytest.raises(ValueError, match="one process per machine"):
        DistributedGP(dataclasses.replace(est.config, impl="mesh"), device="cpu").fit(
            parts=PARTS)
    with pytest.raises(NotImplementedError, match='gram_mode="nystrom" only'):
        run_ranks(M, fit_predict, dict(protocol="broadcast", gram_mode="direct"), PARTS, XQ)
    with pytest.raises(TypeError, match="FittedProtocol"):
        est.health(None)
    with pytest.raises(ValueError, match="available mask has 3 entries"):
        _, (art, _) = (None, _port_run("xla", 0, **BROADCAST))
        DistributedGP(device="cpu").predict(art, XQ, available=[1, 1, 1])
