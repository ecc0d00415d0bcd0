"""repro_torch's per-symbol scheme against the reference's jax_scheme.

Integers match bitwise: codebook tables, packed words, unpacked codes, CRCs
and the greedy rates.  The decorrelating transform matches only up to the
sign of each decorrelated dimension (``torch.linalg.eigh`` and
``jnp.linalg.eigh`` pick eigenvector signs independently), so encode/decode
are held against the reference GIVEN the reference's scheme state, and the
fitted ``T`` is compared row by row up to sign.  Inputs are built in numpy
from a seed and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.core import jax_scheme as JS  # noqa: E402
from repro.core import quantizers as JQ  # noqa: E402
from repro_torch.core import quantizers as TQ  # noqa: E402
from repro_torch.core import torch_scheme as TS  # noqa: E402


@pytest.mark.parametrize("cap", [0, 3, 12])
def test_codebook_tables_equal_reference(cap):
    je, jc = JQ.build_codebook_tables(cap)
    te, tc = TQ.build_codebook_tables(cap)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert TQ.unit_distortion(cap) == JQ.unit_distortion(cap)


def _rates(rng, d, R, zero_dims=(), cap=32):
    live = [j for j in range(d) if j not in zero_dims]
    w = np.zeros(d, np.int32)
    for _ in range(R):
        j = live[rng.integers(len(live))]
        w[j] = min(w[j] + 1, cap)
    return w


# total row bits, width-0 dims: W = 0, 1, 1, 4 words; codes straddling words
PLANE_CASES = [(0, ()), (7, (1,)), (24, ()), (24, (0, 5)), (100, ()), (100, (7,))]


@pytest.mark.parametrize("R,zero_dims", PLANE_CASES)
def test_pack_unpack_crc_bitwise(R, zero_dims):
    rng = np.random.default_rng(R + 3 * len(zero_dims))
    d, n = 8, 40
    w = _rates(rng, d, R, zero_dims, cap=30)
    codes = rng.integers(0, 2 ** w.astype(np.int64), size=(n, d)).astype(np.int32)
    codes[3] = -1  # the padded-row sentinel packs as zeros
    mask = (rng.random(n) > 0.2).astype(np.float32)
    want = np.asarray(JS.pack_codes(jnp.asarray(codes), jnp.asarray(w), total_bits=R,
                                    mask=jnp.asarray(mask)))
    got = TS.pack_codes(torch.from_numpy(codes), torch.from_numpy(w), total_bits=R,
                        mask=torch.from_numpy(mask))
    assert want.dtype == np.uint32 and got.dtype == torch.int32
    np.testing.assert_array_equal(TS.words_to_uint32(got), want)

    words = TS.words_from_uint32(want)
    un_want = np.asarray(JS.unpack_codes(jnp.asarray(want), jnp.asarray(w),
                                         total_bits=R, mask=jnp.asarray(mask)))
    un_got = TS.unpack_codes(words, torch.from_numpy(w), total_bits=R,
                             mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(un_got.numpy(), un_want)

    crc_want = np.asarray(JS.crc_words(jnp.asarray(want), jnp.asarray(mask)))
    np.testing.assert_array_equal(
        TS.crc_words(words, torch.from_numpy(mask)).numpy(), crc_want
    )


@pytest.mark.parametrize("width", [0, 5, 32])
def test_uniform_width_plane_bitwise(width):
    rng = np.random.default_rng(width)
    codes = rng.integers(0, 2**width, size=(6, 9), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JS.pack_codes(jnp.asarray(codes), width))
    got = TS.pack_codes(torch.from_numpy(codes.astype(np.int64)), width)
    np.testing.assert_array_equal(TS.words_to_uint32(got), want)
    back = TS.unpack_codes(TS.words_from_uint32(want), width, num=9)
    np.testing.assert_array_equal(back.numpy(), codes.astype(np.int64))
    np.testing.assert_array_equal(
        TS.crc_words(TS.words_from_uint32(want)).numpy(),
        np.asarray(JS.crc_words(jnp.asarray(want))),
    )


def test_batched_widths_pack_per_machine():
    """The port packs every machine at once with per-machine widths; each
    machine's words equal the reference's pack of that machine alone."""
    rng = np.random.default_rng(11)
    m, n, d, R = 3, 10, 6, 24
    w = np.stack([_rates(rng, d, R, cap=12) for _ in range(m)])
    codes = rng.integers(0, 2 ** w[:, None, :].astype(np.int64), size=(m, n, d))
    got = TS.words_to_uint32(TS.pack_codes(torch.from_numpy(codes), torch.from_numpy(w),
                                           total_bits=R))
    for i in range(m):
        want = np.asarray(JS.pack_codes(jnp.asarray(codes[i].astype(np.int32)),
                                        jnp.asarray(w[i]), total_bits=R))
        np.testing.assert_array_equal(got[i], want)


def _moments(seed, m=4, n=40, d=8):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) for _ in range(m)])
    X = X.astype(np.float32)
    S = np.einsum("mnd,mne->mde", X, X) / n
    return X, S


@pytest.mark.parametrize("R", [0, 7, 24, 100])
def test_fit_scheme_rates_bitwise_and_T_up_to_sign(R):
    X, S = _moments(R)
    Qy = np.broadcast_to(S[0], S.shape)
    cap = JS.codebook_cap(R, 12)
    ref = JS.fit_scheme_batched(jnp.asarray(S), jnp.asarray(Qy), R, cap)
    got = TS.fit_scheme_batched(torch.from_numpy(S), torch.from_numpy(np.array(Qy)), R, cap)
    np.testing.assert_array_equal(got["rates"].numpy(), np.asarray(ref["rates"]))
    # eigenvalues agree to fp32 eigh accuracy (relative to the largest)
    sig_ref = np.asarray(ref["sigma"])
    np.testing.assert_allclose(got["sigma"].numpy(), sig_ref,
                               atol=1e-4 * sig_ref.max())
    T_ref, T_got = np.asarray(ref["T"]), got["T"].numpy()
    signs = np.sign(np.sum(T_ref * T_got, axis=-1, keepdims=True))
    np.testing.assert_allclose(T_got * signs, T_ref, atol=1e-3 * np.abs(T_ref).max())
    one = TS.fit_scheme(torch.from_numpy(S[1]), torch.from_numpy(S[0]), R, cap)
    np.testing.assert_array_equal(one["rates"].numpy(), np.asarray(ref["rates"][1]))


def test_quantize_bitwise_on_the_same_symbols():
    rng = np.random.default_rng(3)
    d = 8
    x = rng.normal(size=(50, d)).astype(np.float32) * 2.0
    sigma = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    rates = _rates(rng, d, 40, cap=12)
    je, jc = JQ.build_codebook_tables(12)
    te, tc = TQ.build_codebook_tables(12)
    codes_ref = np.asarray(JQ.quantize(jnp.asarray(x), jnp.asarray(sigma),
                                       jnp.asarray(rates), je))
    codes = TQ.quantize(torch.from_numpy(x), torch.from_numpy(sigma),
                        torch.from_numpy(rates), te)
    np.testing.assert_array_equal(codes.numpy(), codes_ref)
    np.testing.assert_array_equal(
        TQ.dequantize(codes, torch.from_numpy(sigma), torch.from_numpy(rates), tc).numpy(),
        np.asarray(JQ.dequantize(jnp.asarray(codes_ref), jnp.asarray(sigma),
                                 jnp.asarray(rates), jc)),
    )


def test_encode_decode_given_reference_state():
    """Codes bitwise, reconstructions to fp32 rounding.  R = 24 over d = 8
    leaves bins wide enough that the projection X T^T, rounded differently
    by the two matmul libraries (~1e-7 relative), moves no symbol across a
    bin edge."""
    X, S = _moments(5)
    R, cap = 24, 12
    Qy = np.broadcast_to(S[0], S.shape)
    ref = JS.fit_scheme_batched(jnp.asarray(S), jnp.asarray(Qy), R, cap)
    jt = JS.scheme_tables(R, cap)
    state = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    tt = TS.scheme_tables(R, cap)
    codes = TS.encode(state, torch.from_numpy(X), tt)
    for i in range(X.shape[0]):
        st = {k: v[i] for k, v in ref.items()}
        want = np.asarray(JS.encode(st, jnp.asarray(X[i]), jt))
        np.testing.assert_array_equal(codes[i].numpy(), want)
        dec_want = np.asarray(JS.decode(st, jnp.asarray(want), jt))
        dec = TS.decode({k: v[i] for k, v in state.items()}, codes[i], tt)
        np.testing.assert_allclose(dec.numpy(), dec_want, rtol=1e-5,
                                   atol=1e-5 * np.abs(dec_want).max())
        np.testing.assert_array_equal(
            TS.scaled_centroids({k: v[i] for k, v in state.items()}, tt).numpy(),
            np.asarray(JS.scaled_centroids(st, jt)),
        )
