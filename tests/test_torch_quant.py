"""repro_torch's per-symbol quantizer kernels (``quant_encode``,
``quant_decode``) against the reference's.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference's kernels run as tests/test_kernels.py runs them (the XLA oracle
``encode_ref``/``decode_ref`` and the Pallas kernel in interpret mode).
Inputs are made once with numpy from a seed and handed to both.  Encode
and decode are held bitwise: a count of comparisons and a table lookup
have no rounding.  The one place the reference disagrees with itself is a
code outside [0, C): its Pallas kernel decodes it to 0 (the port does the
same), while ``decode_ref`` indexes with jnp semantics (-1 wraps to the
last column); the tests pin both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core import quantizers as RQ  # noqa: E402
from repro.kernels.quant.ops import (  # noqa: E402
    build_scaled_tables as ref_tables, decode as ref_decode, encode as ref_encode,
)
from repro.kernels.quant.ref import decode_ref, encode_ref  # noqa: E402
from repro_torch.core import quantizers as Q  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.quant.ops import (  # noqa: E402
    build_scaled_tables, decode, decode_cuda, decode_plain, encode, encode_cuda,
    encode_plain,
)


def _case(seed, n, d, bits, max_bits, zero_dims=(), specials=False):
    """sigma, rates and symbols x (numpy), with NaN / +-inf / 0 rows and
    on-edge symbols planted when ``specials``."""
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.05, 4.0, size=d)
    var[list(zero_dims)] = 0.0
    rates = RQ.allocate_bits_greedy(var, bits, max_bits)
    sigma = np.sqrt(var).astype(np.float32)
    x = (rng.normal(size=(n, d)) * sigma).astype(np.float32)
    if specials:
        x[0], x[1], x[2], x[3] = np.nan, np.inf, -np.inf, 0.0
        edges, _ = ref_tables(sigma, rates)
        edges = np.asarray(edges)
        for j in range(d):
            live = edges[j][np.isfinite(edges[j])]
            if live.size:
                x[4, j] = live[rng.integers(live.size)]
    return sigma, rates, x


# n, d, bits, max_bits, zero_dims, specials: ragged n and d, rate-0 dims,
# 4096-entry rows (the Fig. 6 wire's max_bits 12), bits = 0 (E = 128)
CASES = [
    (64, 8, 24, 8, (), False),
    (200, 20, 60, 8, (), True),
    (37, 13, 30, 12, (2, 7), True),
    (25, 21, 24, 12, (), True),
    (9, 5, 0, 8, (), True),
]


def test_allocate_bits_greedy_matches_reference():
    rng = np.random.default_rng(3)
    for d, bits, cap in ((8, 24, 8), (21, 24, 12), (128, 512, 8), (5, 0, 8), (6, 100, 4)):
        var = rng.uniform(0.05, 4.0, size=d)
        var[0] = 0.0
        np.testing.assert_array_equal(Q.allocate_bits_greedy(var, bits, cap),
                                      RQ.allocate_bits_greedy(var, bits, cap))


@pytest.mark.parametrize("n,d,bits,max_bits,zero_dims,specials", CASES)
def test_build_scaled_tables_bitwise(n, d, bits, max_bits, zero_dims, specials):
    sigma, rates, _ = _case(n + d, n, d, bits, max_bits, zero_dims)
    edges, cents = build_scaled_tables(sigma, rates)
    want_e, want_c = ref_tables(sigma, rates)
    assert edges.dtype == torch.float32 and edges.shape == want_e.shape
    np.testing.assert_array_equal(edges.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(cents.numpy(), np.asarray(want_c))
    # tensors in, the same tables (the wire phase passes the card's sigma)
    e2, c2 = build_scaled_tables(torch.from_numpy(sigma), torch.from_numpy(rates))
    assert torch.equal(e2, edges) and torch.equal(c2, cents)


@pytest.mark.parametrize("n,d,bits,max_bits,zero_dims,specials", CASES)
def test_encode_bitwise_against_reference(n, d, bits, max_bits, zero_dims, specials):
    sigma, rates, x = _case(n + d, n, d, bits, max_bits, zero_dims, specials)
    edges, _ = ref_tables(sigma, rates)
    got = encode(torch.from_numpy(x), build_scaled_tables(sigma, rates)[0])
    assert got.dtype == torch.int32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(encode_ref(jnp.asarray(x), edges)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_encode(x, edges, interpret=True)))
    if specials:  # NaN -> 0; +inf -> the finite edges; -inf, rate-0 dims -> 0
        finite = np.isfinite(np.asarray(edges)).sum(1)
        np.testing.assert_array_equal(got[0].numpy(), 0)
        np.testing.assert_array_equal(got[1].numpy(), finite)
        np.testing.assert_array_equal(got[2].numpy(), 0)
        np.testing.assert_array_equal(got[:, list(zero_dims)].numpy(), 0)


@pytest.mark.parametrize("n,d,bits,max_bits,zero_dims,specials", CASES)
def test_decode_bitwise_against_reference(n, d, bits, max_bits, zero_dims, specials):
    sigma, rates, x = _case(n + d, n, d, bits, max_bits, zero_dims, specials)
    edges, cents = ref_tables(sigma, rates)
    codes = np.array(encode_ref(jnp.asarray(x), edges))
    tcents = build_scaled_tables(sigma, rates)[1]
    got = decode(torch.from_numpy(codes), tcents)
    np.testing.assert_array_equal(got.numpy(), np.asarray(decode_ref(jnp.asarray(codes), cents)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_decode(codes, cents,
                                                                     interpret=True)))
    # out of range: -1 and >= C decode to 0, as the reference's kernel does
    C = tcents.shape[1]
    bad = codes.copy()
    bad[0], bad[-1] = -1, C + 5
    got = decode(torch.from_numpy(bad), tcents)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_decode(bad, cents,
                                                                     interpret=True)))
    assert not got[0].any() and not got[-1].any()
    # ... where decode_ref wraps -1 to the last column (jnp indexing)
    np.testing.assert_array_equal(np.asarray(decode_ref(jnp.asarray(bad), cents))[0],
                                  np.asarray(cents)[:, -1])


def test_quant_kernel_agrees_with_core_quantizers():
    """The reference's test_quant_kernel_agrees_with_core_quantizers, through
    the port's core/quantizers.py: the kernel tables give the codes and
    reconstructions of the rate-indexed codebook tables."""
    rng = np.random.default_rng(7)
    d = 16
    var = rng.uniform(0.05, 4.0, size=d)
    rates = Q.allocate_bits_greedy(var, 48, 8)
    sigma = np.sqrt(var).astype(np.float32)
    x = (rng.normal(size=(100, d)) * sigma).astype(np.float32)
    edges, cents = build_scaled_tables(sigma, rates)
    et, ct = Q.build_codebook_tables(int(max(rates.max(), 1)))
    ts, tr = torch.from_numpy(sigma), torch.from_numpy(rates)
    c_core = Q.quantize(torch.from_numpy(x), ts, tr, et)
    c_kern = encode(torch.from_numpy(x), edges)
    assert torch.equal(c_core, c_kern)
    x_core = Q.dequantize(c_core, ts, tr, ct)
    x_kern = decode(c_kern, cents)
    np.testing.assert_allclose(x_core.numpy(), x_kern.numpy(), rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_and_launch_counts():
    assert runtime.choose("quant_encode", torch.zeros(1)) is encode_plain
    assert runtime.choose("quant_decode", torch.zeros(1)) is decode_plain
    runtime.reset_launches()
    sigma, rates, x = _case(1, 10, 4, 8, 8)
    edges, cents = build_scaled_tables(sigma, rates)
    decode(encode(torch.from_numpy(x), edges), cents)
    counts = runtime.launches()
    assert counts["quant_encode"] == 0 and counts["quant_decode"] == 0
    # the kernel wrappers take CUDA tensors only: never a silent CPU run
    with pytest.raises(ValueError, match="CUDA"):
        encode_cuda(torch.from_numpy(x), edges)
    with pytest.raises(ValueError, match="CUDA"):
        decode_cuda(torch.zeros(3, 4, dtype=torch.int32), cents)
