"""repro_torch's decode attention (``decode_attn``) against the
reference's.

On the CPU the port's wrapper runs its plain PyTorch version; the reference
runs ``decode_attn_ref`` and its Pallas kernel in interpret mode, at S a
multiple of the chunk (the two agree there: the Pallas path pads S with
empty V = 0 slots, which changes the no-valid-key mean).  Inputs are made
with numpy from a seed and handed to both; bf16 cases hand both packages
the same bf16 bits (checked through an int16 view).  Tolerance:
1e-5 x max|V| — the output is a convex combination of V's rows, and the
scores' and sums' fp32 rounding moves it by a few ulps of that scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn.ops import decode_attn as ref_decode_attn  # noqa: E402
from repro.kernels.decode_attn.ref import decode_attn_ref  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    decode_attn, decode_attn_cuda, decode_attn_plain,
)


def _inputs(seed, B, S, KV, G, hd, pos, *, bf16=False, ring=False, empty_rows=()):
    """(torch args, jax args) holding the same values (the same bf16 bits)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    K = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    V = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    if ring:  # a wrapped ring: positions pos - S + 1 .. pos in permuted slots
        kpos = np.stack([rng.permutation(np.arange(pos - S + 1, pos + 1)) for _ in range(B)])
    else:
        kpos = np.broadcast_to(np.arange(S), (B, S)).copy()
        kpos[:, pos + 1:] = -1
    kpos[list(empty_rows)] = -1
    kpos = kpos.astype(np.int32)
    t = [torch.from_numpy(a) for a in (q, K, V)]
    j = [jnp.asarray(a) for a in (q, K, V)]
    if bf16:
        t = [a.to(torch.bfloat16) for a in t]
        j = [jnp.asarray(a.view(torch.int16).numpy()).view(jnp.bfloat16) for a in t]
        for a, b in zip(t, j):  # the same bits in both packages
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          np.asarray(b).view(np.int16))
    return (*t, torch.from_numpy(kpos)), (*j, jnp.asarray(kpos))


def _close(got, want, V):
    tol = 1e-5 * float(np.abs(np.asarray(V, np.float32)).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


# B, S, KV, G, hd, window, pos, chunk, bf16
CASES = [
    (2, 128, 2, 3, 16, None, 80, 64, False),
    (1, 256, 4, 1, 32, None, 255, 128, False),
    (2, 256, 1, 4, 8, 64, 250, 64, False),
    (3, 64, 2, 2, 16, 16, 10, 32, False),
    (2, 128, 2, 2, 16, None, 127, 64, True),
    (1, 128, 2, 4, 8, 40, 100, 64, True),
]


@pytest.mark.parametrize("B,S,KV,G,hd,window,pos,chunk,bf16", CASES)
def test_matches_reference(B, S, KV, G, hd, window, pos, chunk, bf16):
    (q, K, V, kpos), (jq, jK, jV, jkpos) = _inputs(S + hd, B, S, KV, G, hd, pos, bf16=bf16)
    got = decode_attn(q, K, V, kpos, pos, window=window)
    assert got.shape == (B, KV, G, hd) and got.dtype == torch.float32
    _close(got, decode_attn_ref(jq, jK, jV, jkpos, pos, window=window), V.float())
    _close(got, ref_decode_attn(jq, jK, jV, jkpos, pos, window=window, chunk=chunk,
                                interpret=True), V.float())


def test_ragged_s_against_reference():
    """S = 100: no padding in the port; the reference's kernel runs it as
    one chunk of 100 (no padded slot either)."""
    (q, K, V, kpos), (jq, jK, jV, jkpos) = _inputs(5, 2, 100, 2, 3, 16, 80)
    got = decode_attn(q, K, V, kpos, 80, window=None)
    _close(got, decode_attn_ref(jq, jK, jV, jkpos, 80), V)
    _close(got, ref_decode_attn(jq, jK, jV, jkpos, 80, chunk=128, interpret=True), V)


@pytest.mark.parametrize("bf16", [False, True])
def test_row_with_no_valid_key_is_the_mean_of_v(bf16):
    (q, K, V, kpos), (jq, jK, jV, jkpos) = _inputs(9, 2, 64, 2, 2, 8, 63, bf16=bf16,
                                                   empty_rows=(1,))
    got = decode_attn(q, K, V, kpos, 63)
    _close(got, decode_attn_ref(jq, jK, jV, jkpos, 63), V.float())
    _close(got, ref_decode_attn(jq, jK, jV, jkpos, 63, chunk=32, interpret=True), V.float())
    mean = V[1].float().mean(0)[:, None, :].expand(2, 2, 8)
    _close(got[1], mean, V.float())
    # window = 0 is a window, not "no window": it masks every slot
    all_masked = decode_attn(q, K, V, kpos, 63, window=0)
    _close(all_masked, V.float().mean(1)[:, :, None, :].expand(2, 2, 2, 8), V.float())


def test_ring_order_invariance():
    """A ring cache stores positions in slot order != position order: only
    kpos matters."""
    (q, K, V, kpos), _ = _inputs(0, 2, 96, 2, 2, 8, 200, ring=True)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(96))
    a = decode_attn(q, K, V, kpos, 200, window=50)
    b = decode_attn(q, K[:, perm], V[:, perm], kpos[:, perm], 200, window=50)
    _close(a, b, V)


def test_pos_as_a_tensor_equals_pos_as_an_int():
    (q, K, V, kpos), _ = _inputs(3, 1, 64, 1, 2, 8, 40)
    a = decode_attn(q, K, V, kpos, 40, window=16)
    b = decode_attn(q, K, V, kpos, torch.tensor(40, dtype=torch.int32), window=16)
    assert torch.equal(a, b)


def test_cpu_dispatch_and_launch_counts():
    assert runtime.choose("decode_attn", torch.zeros(1)) is decode_attn_plain
    runtime.reset_launches()
    (q, K, V, kpos), _ = _inputs(3, 1, 16, 1, 2, 8, 15)
    decode_attn(q, K, V, kpos, 15)
    assert runtime.launches()["decode_attn"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn_cuda(q, K, V, kpos, 15)
