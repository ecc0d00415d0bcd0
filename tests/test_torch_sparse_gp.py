"""repro_torch's GPModel, Titsias sparse GP, one-call entry points, paper
configurations, data generators and the Fig. 4 / Fig. 7 scripts against
the reference's.

What is held, and within what:
* ``GPModel.predict`` and ``nlml`` at the same hyperparameters: 1e-5 of
  the output's scale under the SE kernel; 3e-4 under the linear kernel,
  whose 120 x 120 gram has rank d + 1 = 4, so cond(G + s2 I) ~ 2e3 carries
  fp32 rounding into the mean (read: each package 4e-5 of scale from a
  float64 evaluation, 7.7e-5 apart).  The port takes the prior variances
  from ``prior_diag`` and factorizes once; the reference builds a t x t
  gram;
  ``train_gp``'s training is held in tests/test_torch_fig56.py and
  tests/test_torch_poe_experts.py);
* ``elbo``, ``SGPR.predict`` and ``qu`` at the reference's hyperparameters
  and inducing inputs: 1e-5 of scale (k(x, x) from ``prior_diag`` against
  the reference's diagonal of an n x n gram);
* ``train_sgpr`` for 20 steps from the reference's initial rows (its
  ``jax.random.choice`` draw put in at ``inducing_init``): log-params and Z
  within 1e-4, predictions within 1e-4 of scale (read: 1.7e-6);
* the batched ``train_sgpr`` (one SGPR per leading index) equals the
  single runs within 1e-5; the ELBO lower-bounds the exact marginal
  likelihood (tests/test_sparse_gp.py's check);
* ``poe_baseline``, ``single_center_gp`` and ``broadcast_gp`` equal
  ``DistributedGP`` on the same parts bitwise, and their ledgers equal the
  reference's formulas (``repro/comm/accounting.py``) as integers, the
  host oracles' the batched fits' (tests/test_torch_center.py,
  tests/test_torch_broadcast.py and tests/test_torch_host_oracles.py hold
  the same fits against the reference's own);
* ``gp_paper`` field by field, ``mnist_like_two_digits`` bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gp_paper as ref_paper  # noqa: E402
from repro.core import gp as ref_gp  # noqa: E402
from repro.core import sparse_gp as ref_sgp  # noqa: E402
from repro.comm import accounting as ref_acc  # noqa: E402
from repro.data import synthetic as ref_data  # noqa: E402
from repro_torch.configs import gp_paper  # noqa: E402
from repro_torch.core import DGPConfig, DistributedGP, GPModel, GPParams  # noqa: E402
from repro_torch.core import gp, sparse_gp  # noqa: E402
from repro_torch.core.protocols.broadcast import broadcast_gp  # noqa: E402
from repro_torch.core.protocols.center import single_center_gp  # noqa: E402
from repro_torch.core.protocols.poe import poe_baseline  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import fig4_gp1d, fig7_sparse  # noqa: E402

TOL, TOL_TRAIN, TOL_LINEAR = 1e-5, 1e-4, 3e-4
START = (1.0, 2.0, 0.1)  # a, l^2, noise of tests/test_sparse_gp.py


def _problem(seed=0, n=200, d=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X @ np.ones(d)) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def _params(p):
    return GPParams(*(torch.tensor(float(a)) for a in p))


def _ref_choice(n, m, seed):
    return torch.from_numpy(np.array(
        jax.random.choice(jax.random.PRNGKey(seed), n, (m,), replace=False)))


@pytest.mark.parametrize("kernel", ["se", "linear"])
def test_gp_model_predict_and_nlml(kernel):
    X, y = _problem(1, n=120)
    model = gp.train_gp(torch.from_numpy(X), torch.from_numpy(y), kernel=kernel, steps=2)
    assert isinstance(model, GPModel) and model.gram_backend == "xla"
    p = ref_gp.init_params(0.7, 1.8, 0.05)
    ref = ref_gp.GPModel(kernel, p, jnp.asarray(X), jnp.asarray(y))
    same = GPModel(kernel, _params(p), torch.from_numpy(X), torch.from_numpy(y),
                   gram_backend="pallas")  # the gram kernel's plain version on the CPU
    tol = TOL_LINEAR if kernel == "linear" else TOL
    for Xs in (X[:30], X[:30] + 0.5):
        mu, var = same.predict(Xs)
        want_mu, want_var = ref.predict(jnp.asarray(Xs))
        _close(mu.numpy(), want_mu, tol)
        _close(var.numpy(), want_var, tol)
    _close(float(same.nlml()), float(ref.nlml()), tol)
    assert same.factors() is same.factors()  # factorized once


def test_elbo_predict_and_qu_at_the_references_state():
    X, y = _problem()
    m = 15
    Z = X[:m] + 0.1 * np.random.default_rng(m).normal(size=(m, 3)).astype(np.float32)
    ref = ref_sgp.SGPR("se", ref_gp.init_params(0.8, 1.5, 0.05), jnp.asarray(Z),
                       jnp.asarray(X), jnp.asarray(y))
    got = sparse_gp.SGPR("se", _params(ref.params), torch.from_numpy(Z),
                         torch.from_numpy(X), torch.from_numpy(y))
    _close(float(sparse_gp.elbo(got.params, got.Z, got.X, got.y, "se")),
           float(ref_sgp.elbo(ref.params, ref.Z, ref.X, ref.y, "se")))
    for a, b in zip(got.predict(X[:40]), ref.predict(X[:40])):
        _close(a.numpy(), b)
    for a, b in zip(got.qu(), ref.qu()):
        _close(a.numpy(), b)
    assert got.compact() is got.Z


def test_train_sgpr_from_the_references_rows(monkeypatch):
    monkeypatch.setattr(sparse_gp, "inducing_init", _ref_choice)
    X, y = _problem(1)
    ref = ref_sgp.train_sgpr(X, y, 15, steps=20, key=jax.random.PRNGKey(3))
    got = sparse_gp.train_sgpr(torch.from_numpy(X), torch.from_numpy(y), 15, steps=20, seed=3)
    _close([float(a) for a in got.params], [float(a) for a in ref.params], TOL_TRAIN)
    _close(got.Z.numpy(), ref.Z, TOL_TRAIN)
    for a, b in zip(got.predict(X[:30]), ref.predict(X[:30])):
        _close(a.numpy(), b, TOL_TRAIN)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_batched_train_sgpr_equals_single_runs(backend):
    X, y = _problem(2)
    Xb = torch.from_numpy(X).reshape(2, 100, 3)
    yb = torch.from_numpy(y).reshape(2, 100)
    both = sparse_gp.train_sgpr(Xb, yb, 8, steps=15, seed=40, gram_backend=backend)
    assert both.Z.shape == (2, 8, 3) and both.params.log_a.shape == (2,)
    m_u, s_u = both.qu()
    mu, var = both.predict(X[:9])
    for b in range(2):
        one = sparse_gp.train_sgpr(Xb[b], yb[b], 8, steps=15, seed=40 + b)
        _close(both.Z[b].numpy(), one.Z.numpy())
        _close([float(a[b]) for a in both.params], [float(a) for a in one.params])
        for a, w in zip((m_u[b], s_u[b]), one.qu()):
            _close(a.numpy(), w.numpy())
        for a, w in zip((mu[b], var[b]), one.predict(X[:9])):
            _close(a.numpy(), w.numpy())


def test_elbo_lower_bounds_exact_marginal_likelihood():
    X, y = map(torch.from_numpy, _problem())
    p = gp.init_params(*START)
    exact = -float(gp.nlml_from_gram(gp.se_gram(p, X), y, float(torch.exp(p.log_noise))))
    for m in (5, 20, 80):
        assert float(sparse_gp.elbo(p, X[:m], X, y, "se")) <= exact + 1e-2
    assert float(sparse_gp.elbo(p, X, X, y, "se")) == pytest.approx(exact, abs=0.5)


def _parts(m=4, per=20, d=3):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(m * per, d)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.3 * X[:, 1]).astype(np.float32)
    return [(X[j::m], y[j::m]) for j in range(m)], X[:16] + 0.1


def test_one_call_entry_points_equal_the_front_door():
    parts, Xq = _parts()
    kw = dict(kernel="se", steps=5, gram_backend="pallas")
    art = single_center_gp(parts, 16, gram_mode="direct", device="cpu", **kw)
    est = DistributedGP(DGPConfig(protocol="center", gram_mode="direct", bits_per_sample=16,
                                  **kw), device="cpu")
    for a, b in zip(art.predict(Xq), est.predict(est.fit(parts=parts), Xq)):
        assert torch.equal(a, b)
    lengths, d = [len(p[0]) for p in parts], 3
    assert (art.wire_bits, art.payload_bits, art.integrity_bits) == (
        ref_acc.wire_bits_formula(art.wire.rates.numpy(), lengths, d, skip=0),
        ref_acc.payload_bits_formula(lengths, d, 16, 12, skip=0),
        ref_acc.integrity_bits_formula(lengths, skip=0))

    mu, s2, wire, params = broadcast_gp(parts, 16, Xq, fuse="rbcm", device="cpu", **kw)
    est = DistributedGP(DGPConfig(protocol="broadcast", fusion="rbcm", bits_per_sample=16,
                                  **kw), device="cpu")
    art = est.fit(parts=parts)
    assert wire == art.wire_bits and isinstance(wire, int)
    for a, b in zip((mu, s2), est.predict(art, Xq)):
        assert torch.equal(a, b)
    assert [float(a) for a in params] == [float(a) for a in art.params]
    assert wire == ref_acc.wire_bits_formula(art.wire.rates.numpy(), lengths, d)

    mu, s2, params = poe_baseline(parts, Xq, method="bcm", device="cpu", **kw)
    est = DistributedGP(DGPConfig(protocol="poe", fusion="bcm", **kw), device="cpu")
    art = est.fit(parts=parts)
    for a, b in zip((mu, s2), est.predict(art, Xq)):
        assert torch.equal(a, b)
    assert [float(a) for a in params] == [float(a) for a in art.params]
    assert art.wire_bits == 0


def test_one_call_entry_points_host_oracles():
    parts, Xq = _parts()
    host = single_center_gp(parts, 16, steps=3, impl="host", device="cpu")
    art = single_center_gp(parts, 16, steps=3, device="cpu")
    assert (host.wire_bits, host.payload_bits) == (art.wire_bits, art.payload_bits)
    mu, s2, wire, _ = broadcast_gp(parts, 16, Xq, steps=3, impl="host", device="cpu")
    assert wire == broadcast_gp(parts, 16, Xq, steps=3, device="cpu")[2]
    assert mu.shape == s2.shape == (16,)
    mu, s2, _ = poe_baseline(parts, Xq, steps=3, impl="host", device="cpu")
    assert bool((s2 > 0).all())
    with pytest.raises(ValueError, match="pallas"):
        poe_baseline(parts, Xq, impl="host", gram_backend="pallas", device="cpu")


def test_gp_paper_equals_the_reference():
    assert len(gp_paper.ALL) == len(ref_paper.ALL) == 7
    for got, want in zip(gp_paper.ALL, ref_paper.ALL):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ("FIG2", "FIG4", "FIG5_SARCOS", "FIG7"):
        assert dataclasses.asdict(getattr(gp_paper, name)) == dataclasses.asdict(
            getattr(ref_paper, name))
    assert [dataclasses.asdict(c) for c in gp_paper.FIG6] == [
        dataclasses.asdict(c) for c in ref_paper.FIG6]


def test_mnist_like_two_digits_bitwise():
    for got, want in zip(synthetic.mnist_like_two_digits(50, seed=3),
                         ref_data.mnist_like_two_digits(50, seed=3)):
        assert got.dtype == np.float32 and got.shape == (50, 784)
        np.testing.assert_array_equal(got, want)


def test_regression_dataset_reads_a_real_file(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"X_train": rng.normal(size=(7, 8)).astype(np.float32),
              "y_train": rng.normal(size=7).astype(np.float32),
              "X_test": rng.normal(size=(3, 8)).astype(np.float32),
              "y_test": rng.normal(size=3).astype(np.float32)}
    np.savez(tmp_path / "kin40k.npz", **arrays)
    got = synthetic.regression_dataset("kin40k", data_dir=str(tmp_path))
    want = ref_data.regression_dataset("kin40k", data_dir=str(tmp_path))
    for g, w, key in zip(got, want, ("X_train", "y_train", "X_test", "y_test")):
        np.testing.assert_array_equal(g, arrays[key])
        np.testing.assert_array_equal(g, w)
    # no file for this name: the synthetic data, as without a data_dir
    for g, w in zip(synthetic.regression_dataset("abalone", data_dir=str(tmp_path)),
                    synthetic.regression_dataset("abalone")):
        np.testing.assert_array_equal(g, w)


def test_fig4_runs_and_recovers_the_true_gp():
    rows = fig4_gp1d.main(quick=True, device="cpu")
    assert [r["derived"]["R"] for r in rows] == list(range(1, 9))
    for r in rows:
        R = r["derived"]["R"]
        assert r["ledger"]["rates"] == [R] and r["ledger"]["wire_bits"] == 200 * R
        assert np.isfinite(r["derived"]["mean_mse"]) and np.isfinite(r["derived"]["sd_mse"])
    # the paper's reading: R >= 6 ~ the true GP
    assert all(r["derived"]["corr_with_true"] > 0.99 for r in rows[5:])


def test_fig7_runs_with_the_references_ledgers():
    rows = fig7_sparse.main(quick=True, device="cpu")
    assert rows[0]["derived"]["model"] == "rbcm"
    assert [r["derived"]["R"] for r in rows[1:]] == [2, 4, 8, 16, 32]
    for r in rows:
        assert 0.0 < r["derived"]["smse"] < 1.0
    for r in rows[1:]:  # 9 peers of 10 inducing points, d = 8
        R = r["derived"]["R"]
        assert r["ledger"]["wire_bits"] == 9 * (10 * R + 2 * 8 * 8 * 32 + 2 * 10 * 16)
        assert all(sum(rates) == R for rates in r["ledger"]["rates"])


def test_figure_scripts_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (fig4_gp1d, fig7_sparse):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.main()


@pytest.mark.parametrize("mod", [fig4_gp1d, fig7_sparse])
def test_cli_passes_the_gram_backend(monkeypatch, mod):
    calls = []
    monkeypatch.setattr(mod, "main", lambda **kw: calls.append(kw) or [])
    mod.cli(["--device", "cpu", "--gram-backend", "xla"])
    mod.cli(["--full", "--device", "cpu"])
    assert [(c["quick"], c["device"], c["gram_backend"]) for c in calls] == [
        (True, "cpu", "xla"), (False, "cpu", "pallas")]
