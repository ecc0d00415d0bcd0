"""Center ``gram_mode="direct"`` / ``"nystrom_fitc"`` and broadcast
``gram_mode="direct"``: repro_torch against the reference run live.

Both packages fit the SAME ``parts`` (built in numpy from a seed) from the
SAME starting hyperparameters, for ``gram_backend="xla"`` and ``"pallas"``.
The reference's pallas runs execute its Pallas bodies in interpret mode
(``REPRO_FORCE_PALLAS=1``); the port's run the kernels' plain versions
(CPU tensors).

What is held, and within what:
* ledgers (wire, payload, integrity — fitc's 32 bits a non-center point
  of exact |x|^2 included), lengths and rates: integer-equal.  Two
  independent fits do not share their packed words (the eigenvector signs
  of the two eigh implementations differ), so words and the per-array
  CRC32s are held bitwise where both packages hold the same state: a
  checkpoint of one loaded and re-saved by the other;
* NLML and its gradient at fixed params: 1e-4 relative (the grams differ
  only through X̂, as in tests/test_torch_center.py);
* predictions at steps=0: 1e-4 relative to the output's scale, the same
  X̂ differences carried through a dense solve;
* trained params and predictions at steps=20 (broadcast also with a
  machine lost at serve time): 2e-4 — twenty Adam steps carry the small
  differences forward;
* xla vs pallas inside the port: 1e-5 — the same math, inner products
  summed in another order;
* cross-package checkpoints: 1e-5 — the same factors, served by the two
  packages' matmuls; port save -> load: bitwise.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DGPConfig as RefConfig  # noqa: E402
from repro.core import DistributedGP as RefGP  # noqa: E402
from repro.core.gp import GPParams as RefParams  # noqa: E402
from repro.core.gp import nlml_from_gram as ref_nlml  # noqa: E402
from repro.core.nystrom import nystrom_cross as ref_nystrom_cross  # noqa: E402
from repro.core.protocols.center import CenterGP as RefCenterGP  # noqa: E402
from repro_torch.checkpoint import load_artifact_meta  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP, GPParams  # noqa: E402
from repro_torch.core.gp import (  # noqa: E402
    gram_fn, nlml_from_gram, posterior_apply, posterior_factors, prior_diag,
)
from repro_torch.core.nystrom import nystrom_complete, nystrom_cross  # noqa: E402
from repro_torch.core.protocols.center import CenterGP  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402


M, D, N_PER = 5, 5, 14  # 70 training points over 5 machines
START = (0.2, -0.3, -1.5)  # log_a, log_b, log_noise: the shared start
DOWN = np.array([1, 1, 0, 1, 1], np.float32)  # machine 2 lost at serve time
CASES = [("center", "direct"), ("center", "nystrom_fitc"), ("broadcast", "direct")]
BACKENDS = ["xla", "pallas"]


def _data():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    X = (rng.normal(size=(M * N_PER, D)) @ A.T).astype(np.float32)
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
         + 0.05 * rng.normal(size=X.shape[0])).astype(np.float32)
    Xq = (rng.normal(size=(19, D)) @ A.T).astype(np.float32)
    # ragged shards: machine 4 holds two rows fewer
    parts = [(X[j::M], y[j::M]) for j in range(M)]
    parts[4] = (parts[4][0][:-2], parts[4][1][:-2])
    return parts, Xq


PARTS, XQ = _data()


class _ForcePallas:
    """REPRO_FORCE_PALLAS=1 around the reference's pallas runs."""

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


def _cfg(make, protocol, mode, backend, steps):
    return make(protocol=protocol, gram_mode=mode, gram_backend=backend, steps=steps)


def _ref_run(protocol, mode, backend, steps):
    params = RefParams(*(jnp.float32(v) for v in START))
    est = RefGP(_cfg(RefConfig, protocol, mode, backend, steps))
    with _ForcePallas(backend):
        art = est.fit(parts=PARTS, params=params)
        out = [est.predict(art, XQ)]
        if protocol == "broadcast":
            out.append(est.predict(art, XQ, available=DOWN))
    return art, [tuple(np.asarray(a) for a in o) for o in out]


def _port_serve(est, art, protocol):
    out = [est.predict(art, XQ)]
    if protocol == "broadcast":
        out.append(est.predict(art, XQ, available=DOWN))
    return [tuple(a.numpy() for a in o) for o in out]


def _port_run(protocol, mode, backend, steps):
    params = GPParams(*(torch.tensor(v, dtype=torch.float32) for v in START))
    est = DistributedGP(_cfg(DGPConfig, protocol, mode, backend, steps), device="cpu")
    art = est.fit(parts=PARTS, params=params)
    return art, _port_serve(est, art, protocol)


@pytest.fixture(scope="module")
def fits():
    out = {}
    for protocol, mode in CASES:
        for backend in BACKENDS:
            for steps in (0, 20):
                out[protocol, mode, backend, steps] = (
                    _ref_run(protocol, mode, backend, steps),
                    _port_run(protocol, mode, backend, steps),
                )
    return out


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()))


PARAMS = [(p, m, b) for p, m in CASES for b in BACKENDS]


@pytest.mark.parametrize("protocol,mode,backend", PARAMS)
def test_ledgers_lengths_and_rates(fits, protocol, mode, backend):
    (ref, _), (art, _) = fits[protocol, mode, backend, 0]
    assert (art.wire_bits, art.payload_bits, art.integrity_bits, art.rows_demoted) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits, ref.rows_demoted)
    assert art.lengths == ref.lengths and art.fit_lengths == ref.fit_lengths
    assert art.block_order == ref.block_order and art.gram_mode == mode
    np.testing.assert_array_equal(art.wire.rates.numpy(), np.asarray(ref.wire.rates))
    np.testing.assert_array_equal(art.stream.counts.numpy(), np.asarray(ref.stream.counts))
    assert int(art.stream.cols) == int(ref.stream.cols)


def test_fitc_side_channel_is_32_bits_a_non_center_point(fits):
    (_, _), (fitc, _) = fits["center", "nystrom_fitc", "xla", 0]
    plain = DistributedGP(DGPConfig(steps=0), device="cpu").fit(parts=PARTS)
    extra = 32 * (sum(fitc.lengths) - fitc.n_center)
    assert fitc.wire_bits == plain.wire_bits + extra
    assert fitc.payload_bits == plain.payload_bits + extra
    assert fitc.integrity_bits == plain.integrity_bits


@pytest.mark.parametrize("mode", ["direct", "nystrom_fitc"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_center_nlml_and_gradient_at_fixed_params(fits, mode, backend):
    (ref, _), (art, _) = fits["center", mode, backend, 0]
    ref_builder = RefCenterGP(
        kernel="se", params=None, X_recon=ref.data["X_recon"], y=ref.y,
        n_center=ref.n_center, wire_bits=0, gram_mode=mode,
        sq_norms=ref.data["sq_exact"], gram_backend=backend, wire=ref.wire,
        block_order=ref.block_order, block_lengths=ref.fit_lengths, pack_bits=24,
    )
    builder = CenterGP(
        kernel="se", X_recon=art.data["X_recon"], n_center=art.n_center,
        gram_backend=backend, wire=art.wire, block_order=art.block_order,
        block_lengths=art.fit_lengths, pack_bits=24, gram_mode=mode,
        sq_norms=art.data["sq_exact"],
    )

    def ref_loss(p):
        return ref_nlml(ref_builder._gram(p), ref.y, jnp.exp(p.log_noise))

    with _ForcePallas(backend):
        want, want_g = jax.value_and_grad(ref_loss)(RefParams(*(jnp.float32(v) for v in START)))
    leaves = [torch.tensor(v, dtype=torch.float32, requires_grad=True) for v in START]
    p = GPParams(*leaves)
    got = nlml_from_gram(builder._gram(p), art.y, torch.exp(p.log_noise))
    grads = torch.autograd.grad(got, leaves)
    _close(float(got.detach()), float(want), 1e-4)
    _close(np.array([float(g) for g in grads]), np.array([float(g) for g in want_g]), 1e-4)


@pytest.mark.parametrize("protocol,mode,backend", PARAMS)
def test_predictions_untrained(fits, protocol, mode, backend):
    (_, ref_out), (_, out) = fits[protocol, mode, backend, 0]
    for (mu, var), (rmu, rvar) in zip(out, ref_out):
        _close(mu, rmu, 1e-4)
        _close(var, rvar, 1e-4)


@pytest.mark.parametrize("protocol,mode,backend", PARAMS)
def test_trained_params_and_predictions(fits, protocol, mode, backend):
    (ref, ref_out), (art, out) = fits[protocol, mode, backend, 20]
    _close(np.array([float(a) for a in art.params]),
           np.array([float(a) for a in ref.params]), 2e-4)
    for (mu, var), (rmu, rvar) in zip(out, ref_out):
        _close(mu, rmu, 2e-4)
        _close(var, rvar, 2e-4)


@pytest.mark.parametrize("protocol,mode", CASES)
def test_backends_agree_in_the_port(fits, protocol, mode):
    (_, (_, out_x)), (_, (_, out_p)) = (fits[protocol, mode, "xla", 20],
                                        fits[protocol, mode, "pallas", 20])
    for (mu_x, var_x), (mu_p, var_p) in zip(out_x, out_p):
        _close(mu_p, mu_x, 1e-5)
        _close(var_p, var_x, 1e-5)


def test_fitc_serve_equals_the_dense_fitc_posterior(fits):
    """The cached FITC serve (L_KK, W, the dense factors) equals the
    posterior of the FITC-completed gram with the test covariance mapped
    by :func:`nystrom_cross`, recomputed from scratch."""
    _, (art, out) = fits["center", "nystrom_fitc", "xla", 20]
    p, K = art.params, art.n_center
    k = gram_fn("se")
    Xc, Xr = art.data["Xc"], art.data["X_recon"]
    G_KK, G_KN = k(p, Xc), k(p, Xc, Xr)
    G = nystrom_complete(G_KK, G_KN, exact_diag=prior_diag("se", p, art.data["sq_exact"]))
    Xq = torch.from_numpy(XQ)
    G_sn = nystrom_cross(G_KK, G_KN, k(p, Xq, Xc))
    g_ss = prior_diag("se", p, (Xq**2).sum(-1))
    mu, var = posterior_apply(posterior_factors(G, art.y, torch.exp(p.log_noise)), G_sn, g_ss)
    _close(out[0][0], mu.numpy(), 1e-5)
    _close(out[0][1], var.numpy(), 1e-5)
    assert K == art.factors["L_KK"].shape[0]


def test_nystrom_cross_against_the_reference():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(30, 4)).astype(np.float32)
    Xs = rng.normal(size=(7, 4)).astype(np.float32)
    p = GPParams(*(torch.tensor(v, dtype=torch.float32) for v in START))
    rp = RefParams(*(jnp.float32(v) for v in START))
    k = gram_fn("se")
    from repro.core.gp import gram_fn as ref_gram_fn

    rk = ref_gram_fn("se")
    Xt, Xst = torch.from_numpy(X), torch.from_numpy(Xs)
    got = nystrom_cross(k(p, Xt[:9]), k(p, Xt[:9], Xt), k(p, Xst, Xt[:9]))
    want = ref_nystrom_cross(rk(rp, X[:9]), rk(rp, X[:9], X), rk(rp, Xs, X[:9]))
    _close(got.numpy(), np.asarray(want), 1e-5)


@pytest.mark.parametrize("protocol,mode,backend", PARAMS)
def test_reference_checkpoint_serves_in_port(fits, protocol, mode, backend, tmp_path):
    (ref, ref_out), _ = fits[protocol, mode, backend, 20]
    RefGP(RefConfig()).save(ref, str(tmp_path / "ref"))
    est = DistributedGP(device="cpu")
    art = est.load(str(tmp_path / "ref"))
    assert art.config.gram_mode == mode and art.config.gram_backend == backend
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        ref.wire_bits, ref.payload_bits, ref.integrity_bits)
    np.testing.assert_array_equal(art.wire.codes.numpy(),
                                  np.asarray(ref.wire.codes).view(np.int32))
    for (mu, var), (rmu, rvar) in zip(_port_serve(est, art, protocol), ref_out):
        _close(mu, rmu, 1e-5)
        _close(var, rvar, 1e-5)
    # re-saved by the port: every array's CRC32 is the reference's
    est.save(art, str(tmp_path / "port"))
    want = load_artifact_meta(str(tmp_path / "ref"))["array_checksums"]
    assert load_artifact_meta(str(tmp_path / "port"))["array_checksums"] == want


@pytest.mark.parametrize("protocol,mode,backend", PARAMS)
def test_port_checkpoint_serves_in_reference(fits, protocol, mode, backend, tmp_path):
    _, (art, out) = fits[protocol, mode, backend, 20]
    DistributedGP(device="cpu").save(art, str(tmp_path / "port"))
    ref = RefGP.load(str(tmp_path / "port"))
    assert ref.gram_mode == mode and ref.config.gram_backend == backend
    np.testing.assert_array_equal(np.asarray(ref.wire.codes).view(np.int32),
                                  art.wire.codes.numpy())
    est = RefGP(RefConfig())
    with _ForcePallas(backend):
        ref_out = [est.predict(ref, XQ)]
        if protocol == "broadcast":
            ref_out.append(est.predict(ref, XQ, available=DOWN))
    for (mu, var), (rmu, rvar) in zip(out, ref_out):
        _close(np.asarray(rmu), mu, 1e-5)
        _close(np.asarray(rvar), var, 1e-5)
    RefGP(RefConfig()).save(ref, str(tmp_path / "ref"))
    want = load_artifact_meta(str(tmp_path / "port"))["array_checksums"]
    assert load_artifact_meta(str(tmp_path / "ref"))["array_checksums"] == want


@pytest.mark.parametrize("protocol,mode", CASES)
def test_port_roundtrip_is_bitwise(fits, protocol, mode, tmp_path):
    _, (art, out) = fits[protocol, mode, "pallas", 20]
    est = DistributedGP(device="cpu")
    est.save(art, str(tmp_path))
    back = est.load(str(tmp_path))
    for (mu2, var2), (mu, var) in zip(_port_serve(est, back, protocol), out):
        np.testing.assert_array_equal(mu2, mu)
        np.testing.assert_array_equal(var2, var)


@pytest.mark.parametrize("protocol,mode", CASES)
def test_cpu_path_launches_no_kernel(protocol, mode):
    runtime.reset_launches()
    _port_run(protocol, mode, "pallas", 1)
    counts = runtime.launches()
    assert {"gram", "qgram_packed"} <= set(counts)
    assert set(counts.values()) == {0}, counts


def test_broadcast_direct_keeps_the_unfused_serve(fits):
    """The direct views have no Nyström serve cache: they serve through the
    dense posterior and the fusion rule, never the fused epilogue."""
    from repro_torch.core.protocols.broadcast import _uses_fused_epilogue
    from repro_torch.core.registry import FUSIONS

    _, (art, _) = fits["broadcast", "direct", "pallas", 20]
    assert set(art.factors) == {"L", "alpha"}
    assert not _uses_fused_epilogue(art, FUSIONS.get(art.fuse))
