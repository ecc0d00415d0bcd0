"""The fusion rules of the port against the reference: every registered
fusion's ``fuse``, ``moments`` and ``finalize`` (``repro_torch.core.fusion``
/ ``repro_torch.core.poe`` against ``repro.core.fusion`` /
``repro.core.poe``), healthy and with availability weights that hold zeros.

The same numpy inputs (float32) go to both packages.  Tolerance: rtol
1e-6 with atol 1e-6 times the output's scale — the formulas are term for
term the same, so only the order of the sums over the m experts differs
(a few ulps); the precision rows' 1/s2 values reach ~1e2 here.  Inside the
port, moments -> finalize against fuse: rtol and atol 2e-5 — an algebraic
rearrangement (the KL finalize subtracts mu^2 from the summed second
moments; the precision rows sum 1/s2 before dividing), not the same sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core.fusion  # noqa: E402,F401  (registers the reference rules)
import repro.core.poe  # noqa: E402,F401
from repro.core.registry import FUSIONS as REF_FUSIONS  # noqa: E402
from repro_torch.core import fusion, poe  # noqa: E402,F401
from repro_torch.core.registry import FUSIONS  # noqa: E402

NAMES = ["kl", "poe", "gpoe", "bcm", "rbcm"]
M, T = 5, 17


def _inputs(seed):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(M, T)).astype(np.float32)
    s2s = rng.uniform(0.01, 1.0, size=(M, T)).astype(np.float32)
    prior = (s2s.max(0) + rng.uniform(0.1, 1.0, size=T)).astype(np.float32)
    return mus, s2s, prior


WEIGHTS = {"healthy": None, "one down": np.array([1, 0, 1, 1, 1], np.float32),
           "two down": np.array([0, 1, 1, 0, 1], np.float32)}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def test_registered_names_match_the_reference():
    assert set(NAMES) <= set(FUSIONS.names())
    for name in NAMES:
        spec = FUSIONS.get(name)
        assert spec.name == name and spec.moments is not None and spec.finalize is not None
        assert name in REF_FUSIONS


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("name", NAMES)
def test_fuse_matches_reference(name, weights):
    mus, s2s, prior = _inputs(1)
    w = WEIGHTS[weights]
    ref, port = REF_FUSIONS.get(name), FUSIONS.get(name)
    args = (jnp.asarray(mus), jnp.asarray(s2s), jnp.asarray(prior))
    targs = (torch.from_numpy(mus), torch.from_numpy(s2s), torch.from_numpy(prior))
    if w is None:
        want, got = ref.fuse(*args), port.fuse(*targs)
    else:
        want, got = ref.fuse(*args, jnp.asarray(w)), port.fuse(*targs, torch.from_numpy(w))
    for g, r in zip(got, want):
        _close(g.numpy(), r)


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("name", NAMES)
def test_moments_and_finalize_match_reference(name, weights):
    mus, s2s, prior = _inputs(2)
    w = WEIGHTS[weights]
    ref, port = REF_FUSIONS.get(name), FUSIONS.get(name)
    S_ref, S = 0.0, 0.0
    for i in range(M):
        wi = None if w is None else float(w[i])
        S_ref = S_ref + ref.moments(jnp.asarray(mus[i]), jnp.asarray(s2s[i]),
                                    jnp.asarray(prior), None if wi is None else jnp.float32(wi))
        rows = port.moments(torch.from_numpy(mus[i]), torch.from_numpy(s2s[i]),
                            torch.from_numpy(prior),
                            None if wi is None else torch.tensor(wi))
        assert rows.shape == (3, T)
        _close(rows.numpy(), ref.moments(jnp.asarray(mus[i]), jnp.asarray(s2s[i]),
                                         jnp.asarray(prior),
                                         None if wi is None else jnp.float32(wi)))
        S = S + rows
    _close(S.numpy(), S_ref)
    for g, r in zip(port.finalize(S, M, torch.from_numpy(prior)),
                    ref.finalize(S_ref, M, jnp.asarray(prior))):
        _close(g.numpy(), r)


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("name", NAMES)
def test_moments_then_finalize_equals_fuse(name, weights):
    """The decomposition the fused epilogue relies on, inside the port."""
    mus, s2s, prior = (torch.from_numpy(a) for a in _inputs(3))
    w = WEIGHTS[weights]
    spec = FUSIONS.get(name)
    wt = None if w is None else torch.from_numpy(w)
    S = sum(spec.moments(mus[i], s2s[i], prior, None if wt is None else wt[i])
            for i in range(M))
    got = spec.finalize(S, M, prior)
    want = spec.fuse(mus, s2s, prior) if wt is None else spec.fuse(mus, s2s, prior, wt)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-5, atol=2e-5)


def test_kl_fuse_full_covariance_matches_reference():
    from repro.core.fusion import kl_fuse as ref_kl_fuse

    rng = np.random.default_rng(4)
    mus = rng.normal(size=(M, 4)).astype(np.float32)
    A = rng.normal(size=(M, 4, 4)).astype(np.float32)
    Sig = A @ A.transpose(0, 2, 1)
    got = fusion.kl_fuse(torch.from_numpy(mus), torch.from_numpy(Sig))
    want = ref_kl_fuse(jnp.asarray(mus), jnp.asarray(Sig))
    for g, r in zip(got, want):
        _close(g.numpy(), r)
