"""The §5.1 center protocol end to end: repro_torch against the reference.

Both packages fit the SAME ``parts`` (built in numpy from a seed) from the
SAME starting hyperparameters, for ``gram_backend="xla"`` and ``"pallas"``.
The reference's pallas fits run the Pallas bodies in interpret mode
(``REPRO_FORCE_PALLAS=1``); the port's run the kernels' plain versions
(CPU tensors).

Tolerances and why:
* ledgers and rates: integer-equal (they depend only on eigenvalues and
  lengths);
* X̂: 1e-4 relative to the data scale — the two eigh implementations agree
  to ~1e-6 relative per transform entry, and X̂ = dequant(code) T_inv^T
  sums d such terms;
* NLML and its gradient at fixed params, predictions at steps=0: 1e-4
  relative — the grams differ only through X̂;
* trained params and predictions at steps=20: 2e-4 — twenty Adam steps
  carry the same small differences forward;
* cross-package checkpoints: 1e-5 — the same factors, served by the two
  packages' matmuls.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_mesh import fit_predict  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro.core.gp import nlml_from_gram as ref_nlml  # noqa: E402
from repro.core.protocols.center import CenterGP as RefCenterGP  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP, GPParams  # noqa: E402
from repro_torch.core.gp import nlml_from_gram  # noqa: E402
from repro_torch.core.protocols.center import CenterGP  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402


M, D, N_PER = 6, 6, 16  # 96 training points over 6 machines
START = (0.2, -0.3, -1.5)  # log_a, log_b, log_noise: the shared start


def _data():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    X = (rng.normal(size=(M * N_PER, D)) @ A.T).astype(np.float32)
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
         + 0.05 * rng.normal(size=X.shape[0])).astype(np.float32)
    Xq = (rng.normal(size=(24, D)) @ A.T).astype(np.float32)
    parts = [(X[j::M], y[j::M]) for j in range(M)]
    return parts, Xq


PARTS, XQ = _data()


def _ref_fit(backend, steps, monkeypatch_env):
    params = RefParams(*(jnp.float32(v) for v in START))
    cfg = RefConfig(gram_backend=backend, steps=steps)
    with monkeypatch_env():
        art = RefGP(cfg).fit(parts=PARTS, params=params)
        mu, var = RefGP(cfg).predict(art, XQ)
    return art, np.asarray(mu), np.asarray(var)


def _port_fit(backend, steps):
    params = GPParams(*(torch.tensor(v, dtype=torch.float32) for v in START))
    est = DistributedGP(DGPConfig(gram_backend=backend, steps=steps), device="cpu")
    art = est.fit(parts=PARTS, params=params)
    mu, var = est.predict(art, XQ)
    return art, mu.numpy(), var.numpy()


class _ForcePallas:
    """REPRO_FORCE_PALLAS=1 for the reference's pallas fits: its kernels
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


@pytest.fixture(scope="module")
def fits():
    out = {}
    for backend in ("xla", "pallas"):
        for steps in (0, 20):
            ref = _ref_fit(backend, steps, lambda: _ForcePallas(backend))
            out[backend, steps] = (ref, _port_fit(backend, steps))
    return out


BACKENDS = ["xla", "pallas"]


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_ledgers_rates_and_reconstruction(fits, backend):
    (ref, _, _), (art, _, _) = fits[backend, 0]
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits)
    assert art.lengths == ref.lengths and art.block_order == ref.block_order
    np.testing.assert_array_equal(art.wire.rates.numpy(), np.asarray(ref.wire.rates))
    _close(art.data["X_recon"].numpy(), ref.data["X_recon"], 1e-4)
    _close(art.wire.decoded.numpy(), ref.wire.decoded, 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_nlml_and_gradient_at_fixed_params(fits, backend):
    (ref, _, _), (art, _, _) = fits[backend, 0]
    ref_builder = RefCenterGP(
        kernel="se", params=None, X_recon=ref.data["X_recon"], y=ref.y,
        n_center=ref.n_center, wire_bits=0, gram_backend=backend, wire=ref.wire,
        block_order=ref.block_order, block_lengths=ref.fit_lengths,
        pack_bits=24,
    )
    builder = CenterGP(
        kernel="se", X_recon=art.data["X_recon"], n_center=art.n_center,
        gram_backend=backend, wire=art.wire, block_order=art.block_order,
        block_lengths=art.fit_lengths, pack_bits=24,
    )

    def ref_loss(p):
        return ref_nlml(ref_builder._gram(p), ref.y, jnp.exp(p.log_noise))

    p0 = RefParams(*(jnp.float32(v) for v in START))
    want, want_g = jax.value_and_grad(ref_loss)(p0)
    leaves = [torch.tensor(v, dtype=torch.float32, requires_grad=True) for v in START]
    p = GPParams(*leaves)
    got = nlml_from_gram(builder._gram(p), art.y, torch.exp(p.log_noise))
    grads = torch.autograd.grad(got, leaves)
    _close(float(got.detach()), float(want), 1e-4)
    _close(np.array([float(g) for g in grads]), np.array([float(g) for g in want_g]), 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_predictions_untrained_tight(fits, backend):
    (_, rmu, rvar), (_, mu, var) = fits[backend, 0]
    _close(mu, rmu, 1e-4)
    _close(var, rvar, 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_trained_params_and_predictions(fits, backend):
    (ref, rmu, rvar), (art, mu, var) = fits[backend, 20]
    _close(np.array([float(a) for a in art.params]),
           np.array([float(a) for a in ref.params]), 2e-4)
    _close(mu, rmu, 2e-4)
    _close(var, rvar, 2e-4)


def test_backends_agree_in_the_port(fits):
    (_, (_, mu_x, var_x)), (_, (_, mu_p, var_p)) = fits["xla", 20], fits["pallas", 20]
    _close(mu_p, mu_x, 1e-5)
    _close(var_p, var_x, 1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_checkpoint_serves_in_port(fits, backend, tmp_path):
    (ref, rmu, rvar), _ = fits[backend, 20]
    RefGP(RefConfig()).save(ref, str(tmp_path))
    est = DistributedGP(device="cpu")
    art = est.load(str(tmp_path))
    assert art.wire.codes.dtype == torch.int32 and art.config.gram_backend == backend
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits)
    mu, var = est.predict(art, XQ)
    _close(mu.numpy(), rmu, 1e-5)
    _close(var.numpy(), rvar, 1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_checkpoint_serves_in_reference(fits, backend, tmp_path):
    _, (art, mu, var) = fits[backend, 20]
    est = DistributedGP(device="cpu")
    est.save(art, str(tmp_path))
    ref = RefGP.load(str(tmp_path))
    assert ref.wire.codes.dtype == jnp.uint32
    np.testing.assert_array_equal(
        np.asarray(ref.wire.codes).view(np.int32), art.wire.codes.numpy()
    )
    with _ForcePallas(backend):
        rmu, rvar = RefGP(RefConfig()).predict(ref, XQ)
    _close(np.asarray(rmu), mu, 1e-5)
    _close(np.asarray(rvar), var, 1e-5)


def test_port_roundtrip_is_bitwise(fits, tmp_path):
    _, (art, mu, var) = fits["pallas", 20]
    est = DistributedGP(device="cpu")
    est.save(art, str(tmp_path))
    back = est.load(str(tmp_path))
    mu2, var2 = est.predict(back, XQ)
    np.testing.assert_array_equal(mu2.numpy(), mu)
    np.testing.assert_array_equal(var2.numpy(), var)


def test_cpu_path_launches_no_kernel():
    runtime.reset_launches()
    _port_fit("pallas", 1)
    counts = runtime.launches()
    assert {"gram", "qgram_packed"} <= set(counts) and not any(counts.values())


def test_nonfinite_query_rows_get_the_prior(fits):
    _, (art, mu, var) = fits["xla", 20]
    Xq = XQ.copy()
    Xq[2, 1] = np.nan
    mu2, var2 = DistributedGP(device="cpu").predict(art, Xq)
    noise = float(torch.exp(art.params.log_noise))
    assert float(mu2[2]) == 0.0
    np.testing.assert_allclose(float(var2[2]), float(torch.exp(art.params.log_a)) + noise,
                               rtol=1e-6)
    np.testing.assert_array_equal(np.delete(mu2.numpy(), 2), np.delete(mu, 2))


def test_unported_paths_raise_naming_their_slice():
    # every DGPConfig value is ported: the mesh fits as the reference's does
    # (its ledgers and answers are the batched fit's) on one process per
    # machine, and in one process it refuses, as the reference does on too
    # few devices; fault plans and the vq scheme (tests/test_torch_faults.py,
    # tests/test_torch_vq.py) refuse what the reference refuses
    est = DistributedGP(device="cpu")
    with pytest.raises(ValueError, match="one process per machine"):
        DistributedGP(DGPConfig(impl="mesh"), device="cpu").fit(parts=PARTS)
    got = run_ranks(M, fit_predict, {}, PARTS, XQ)[0]
    art = est.fit(parts=PARTS)
    mu, var = est.predict(art, XQ)
    assert got["impl"] == "mesh" and got["lengths"] == art.lengths
    assert (got["wire_bits"], got["payload_bits"], got["integrity_bits"]) == (
        art.wire_bits, art.payload_bits, art.integrity_bits)
    _close(got["mu"], mu.numpy(), 1e-6)
    _close(got["var"], var.numpy(), 1e-6)
    with pytest.raises(ValueError, match="known protocols"):
        DGPConfig(protocol="nope")
    with pytest.raises(TypeError, match="FaultPlan"):
        DGPConfig(faults=object())
    with pytest.raises(TypeError, match="FittedProtocol"):
        est.health(None)
