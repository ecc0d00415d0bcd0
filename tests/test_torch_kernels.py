"""repro_torch kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels have no CPU mode); the reference's kernels run their Pallas bodies in
interpret mode, as tests/test_kernels.py runs them.  Inputs are built once
in numpy from a seed and handed to both.  tests/test_torch_gpu.py holds the
CUDA kernels against these plain versions on the card.

Tolerances: every comparison is fp32 against fp32 with sums over at most
d = 8 terms taken in different orders, so outputs agree to a few fp32
ulps of the largest partial sum: rtol 1e-5 with atol 1e-5 times the
output's scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import jax_scheme as JS  # noqa: E402
from repro.kernels.gram.ops import gram as ref_gram  # noqa: E402
from repro.kernels.qgram.ops import qgram_packed as ref_qgram_packed  # noqa: E402
from repro_torch.core import torch_scheme as TS  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.gram.ops import gram, gram_cuda, gram_plain  # noqa: E402
from repro_torch.kernels.qgram.ops import (  # noqa: E402
    qgram_packed, qgram_packed_batched, qgram_packed_cuda, qgram_packed_plain,
)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale)


# a query batch against a center block, a square block, ragged edges of
# every axis and degenerate ones, at test size (d <= 8; the main path's
# d = 21 runs in tests/test_torch_gpu.py and chip_smoke.py)
GRAM_SHAPES = [(128, 25, 8), (25, 25, 7), (130, 70, 8), (1, 1, 1), (8, 3, 5)]


@pytest.mark.parametrize("n,p,d", GRAM_SHAPES)
def test_gram_matches_reference_kernel(n, p, d):
    rng = np.random.default_rng(n * 1000 + p * 10 + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    want = ref_gram(x, y, interpret=True)
    got = gram(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (n, p) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_gram_backward_matches_reference_vjp():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    y = rng.normal(size=(7, 5)).astype(np.float32)
    g = rng.normal(size=(12, 7)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: ref_gram(a, b), jnp.asarray(x), jnp.asarray(y))
    want_dx, want_dy = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    gram(xt, yt).backward(torch.from_numpy(g))
    _close(xt.grad.numpy(), want_dx)
    _close(yt.grad.numpy(), want_dy)


def _packed_case(seed, m, n, d, p, R, zero_dims=(), mask_frac=0.0, cap=12):
    """Random per-machine rates summing to at most R (none on the width-0
    dims), random codes packed by the REFERENCE's pack_codes, tables, a
    per-machine projection and a row mask."""
    rng = np.random.default_rng(seed)
    live = [j for j in range(d) if j not in zero_dims]
    rates = np.zeros((m, d), np.int32)
    for i in range(m):
        for _ in range(R):
            j = live[rng.integers(len(live))]
            rates[i, j] = min(rates[i, j] + 1, cap)
    high = 2 ** rates[:, None, :].astype(np.int64)
    codes = rng.integers(0, high, size=(m, n, d)).astype(np.int32)
    words = np.stack([
        np.asarray(JS.pack_codes(jnp.asarray(codes[i]), jnp.asarray(rates[i]),
                                 total_bits=R))
        for i in range(m)
    ])
    cents = rng.normal(size=(m, d, 2**cap)).astype(np.float32)
    proj = rng.normal(size=(m, p, d)).astype(np.float32)
    mask = (rng.random((m, n)) >= mask_frac).astype(np.float32)
    return words, rates, cents, proj, mask


PACKED_CASES = [
    # R, zero_dims, mask_frac: W = 0, 1, 1 and 4 words per row; width-0
    # dims; masked rows; n and p off the tile
    (0, (), 0.0),
    (7, (2,), 0.25),
    (24, (), 0.0),
    (24, (0, 7), 0.3),
    (100, (), 0.0),
    (100, (3,), 0.2),
]


@pytest.mark.parametrize("R,zero_dims,mask_frac", PACKED_CASES)
def test_qgram_packed_matches_reference_kernel(R, zero_dims, mask_frac):
    m, n, d, p = 3, 37, 8, 11
    words, rates, cents, proj, mask = _packed_case(
        R * 10 + len(zero_dims), m, n, d, p, R, zero_dims, mask_frac
    )
    got = qgram_packed_batched(
        TS.words_from_uint32(words), torch.from_numpy(rates),
        torch.from_numpy(cents), torch.from_numpy(proj), total_bits=R,
        mask=torch.from_numpy(mask),
    )
    assert got.shape == (m, n, p)
    for i in range(m):
        want = ref_qgram_packed(
            jnp.asarray(words[i]), jnp.asarray(rates[i]), jnp.asarray(cents[i]),
            jnp.asarray(proj[i]), total_bits=R, mask=jnp.asarray(mask[i]),
            interpret=True,
        )
        _close(got[i].numpy(), want)
        one = qgram_packed(
            TS.words_from_uint32(words[i]), torch.from_numpy(rates[i]),
            torch.from_numpy(cents[i]), torch.from_numpy(proj[i]), total_bits=R,
            mask=torch.from_numpy(mask[i]),
        )
        np.testing.assert_array_equal(one.numpy(), got[i].numpy())


def test_qgram_packed_shared_projection_equals_per_machine():
    words, rates, cents, proj, mask = _packed_case(5, 2, 9, 6, 4, 24)
    args = (TS.words_from_uint32(words), torch.from_numpy(rates), torch.from_numpy(cents))
    shared = qgram_packed_batched(*args, torch.from_numpy(proj[0]), total_bits=24)
    per = qgram_packed_batched(
        *args, torch.from_numpy(np.stack([proj[0], proj[0]])), total_bits=24
    )
    _close(shared.numpy(), per.numpy())


def test_launch_counters_stay_zero_on_cpu():
    runtime.reset_launches()
    x = torch.randn(9, 4)
    gram(x.requires_grad_(True), torch.randn(5, 4)).sum().backward()
    words, rates, cents, proj, mask = _packed_case(3, 2, 9, 6, 4, 24)
    qgram_packed_batched(
        TS.words_from_uint32(words), torch.from_numpy(rates), torch.from_numpy(cents),
        torch.from_numpy(proj), total_bits=24,
    )
    counts = runtime.launches()
    assert {"gram", "qgram_packed"} <= set(counts) and not any(counts.values())


def test_dispatch_sends_cpu_to_plain_and_refuses_other_devices():
    assert runtime.choose("gram", torch.zeros(1)) is gram_plain
    assert runtime.choose("qgram_packed", torch.zeros(1)) is qgram_packed_plain
    with pytest.raises(ValueError, match="no implementation"):
        runtime.choose("gram", torch.zeros(1, device="meta"))
    # the kernel wrappers take CUDA tensors only: never a silent CPU run
    with pytest.raises(ValueError, match="CUDA"):
        gram_cuda(torch.zeros(2, 2), torch.zeros(2, 2))
    words, rates, cents, proj, mask = _packed_case(3, 1, 4, 3, 2, 7)
    with pytest.raises(ValueError, match="CUDA"):
        qgram_packed_cuda(
            TS.words_from_uint32(words), torch.from_numpy(rates),
            torch.from_numpy(cents), torch.from_numpy(proj), total_bits=7,
        )
