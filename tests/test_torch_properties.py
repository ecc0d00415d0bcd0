"""The five invariants of tests/test_properties.py, held on the port —
derandomized: each runs over a fixed list of seeds (and sizes) drawn in
numpy, in place of the reference's hypothesis draws.

* quantizer idempotence: encode(decode(code)) is the code;
* scheme determinism: two fits of the same moments encode alike;
* the reverse waterfill is monotone in the distortion budget;
* the KL-fused mean lies inside the experts' range, its variance > 0;
* the PoE variance is never above the best expert's.

Where the port computes what the reference computes (the codes, the
waterfill), it is also held to the reference on the same inputs: integers
bitwise, the float64 waterfill to 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core import quantizers as RQ  # noqa: E402
from repro.core.rate_distortion import reverse_waterfill as ref_waterfill  # noqa: E402
from repro_torch.core import quantizers as Q  # noqa: E402
from repro_torch.core.fusion import kl_fuse_diag  # noqa: E402
from repro_torch.core.poe import poe  # noqa: E402
from repro_torch.core.rate_distortion import reverse_waterfill  # noqa: E402
from repro_torch.core.schemes import PerSymbolScheme  # noqa: E402

SEEDS = [0, 1, 7, 42, 1234, 9999]


@pytest.mark.parametrize("rate", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("seed", [0, 17, 9999])
def test_quantizer_idempotent(rate, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(50, 1)).astype(np.float32))
    rates = torch.tensor([rate], dtype=torch.int32)
    sigma = torch.tensor([1.0])
    edges, cents = Q.build_codebook_tables(rate)
    c1 = Q.quantize(x, sigma, rates, edges)
    c2 = Q.quantize(Q.dequantize(c1, sigma, rates, cents), sigma, rates, edges)
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())
    re, _ = RQ.build_codebook_tables(rate)
    want = RQ.quantize(jnp.asarray(x.numpy()), jnp.asarray([1.0], jnp.float32),
                       jnp.asarray(rates.numpy()), re)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_scheme_deterministic(seed):
    rng = np.random.default_rng(seed)
    d = 6
    A = rng.normal(size=(d, d))
    B = rng.normal(size=(d, d))
    Qx, Qy = A @ A.T / d, B @ B.T / d
    X = rng.normal(size=(40, d)).astype(np.float32)
    s1 = PerSymbolScheme(18).fit(Qx, Qy)
    s2 = PerSymbolScheme(18).fit(Qx, Qy)
    np.testing.assert_array_equal(s1.encode(X).numpy(), s2.encode(X).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 5, 12])
def test_waterfill_monotone_in_D(seed, n):
    rng = np.random.default_rng(seed)
    eigs = rng.uniform(0.01, 10.0, size=n)
    frac = float(rng.uniform(0.01, 1.0))
    D1, D2 = frac * eigs.sum() * 0.5, frac * eigs.sum()
    q1, q2 = reverse_waterfill(eigs, D1), reverse_waterfill(eigs, D2)
    assert np.all(q1 <= q2 + 1e-9)  # more budget: weakly more distortion a dimension
    np.testing.assert_allclose(q1, ref_waterfill(eigs, D1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_fusion_mean_within_expert_range(seed):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(5, 3)).astype(np.float32)
    s2s = rng.uniform(0.1, 2.0, size=(5, 3)).astype(np.float32)
    mu, s2 = kl_fuse_diag(torch.from_numpy(mus), torch.from_numpy(s2s))
    assert np.all(mu.numpy() <= mus.max(0) + 1e-6)
    assert np.all(mu.numpy() >= mus.min(0) - 1e-6)
    assert np.all(s2.numpy() > 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_poe_variance_never_exceeds_best_expert(seed):
    rng = np.random.default_rng(seed)
    mus = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    s2s = torch.from_numpy(rng.uniform(0.1, 3.0, size=(4, 6)).astype(np.float32))
    _, s2 = poe(mus, s2s)
    assert np.all(s2.numpy() <= s2s.numpy().min(0) + 1e-6)
