"""repro_torch's unpacked-code fused dequantize+gram (``qgram``) against
the reference's, and the repaired ``decode_gathered``.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference's ``qgram`` runs its Pallas kernel in interpret mode and its XLA
default.  Inputs are made with numpy from a seed and handed to both.
Tolerance: fp32 sums over d terms taken in different orders, so rtol 1e-5
with atol 1e-5 x max(|X̂| |y|^T), the bound the card's ``gram`` check uses.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.qgram.ops import qgram as ref_qgram  # noqa: E402
from repro_torch.core import torch_scheme as TS  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.gram.ops import gram  # noqa: E402
from repro_torch.kernels.qgram.ops import (  # noqa: E402
    qgram, qgram_batched, qgram_cuda, qgram_packed_batched, qgram_plain,
)
from repro_torch.kernels.qgram.ref import decode_gathered  # noqa: E402
from repro_torch.kernels.quant.cases import qgram_operands, quant_operands  # noqa: E402
from repro_torch.kernels.quant.ops import decode, encode  # noqa: E402


def _close(got, want, xhat, y):
    scale = float((np.abs(xhat) @ np.abs(y).swapaxes(-1, -2)).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * max(1.0, scale))


def test_decode_gathered_sends_codes_outside_the_table_to_zero():
    """-1 (the pad sentinel) and codes >= C decode to 0, as the reference's
    one-hot kernels and, for -1, its ``_qgram_xla`` do.  A negative code
    used to reach ``torch.gather`` and raise."""
    cents = torch.arange(1.0, 13.0).reshape(1, 3, 4)  # (m, d, C), no zero entry
    codes = torch.tensor([[[0, 3, 1], [-1, -1, -1], [2, -1, 4], [-5, 1, 7]]])
    got = decode_gathered(codes, cents)
    want = torch.tensor([[[1.0, 8.0, 10.0], [0, 0, 0], [3.0, 0, 0], [0, 6.0, 0]]])
    assert torch.equal(got, want)


# m, n, d, p, bits, max_bits, pad_rows, shared_y: ragged n, p and d, -1
# padded rows, shared and per-machine y, 4096-entry tables
CASES = [
    (1, 64, 8, 32, 24, 8, 0, True),
    (3, 37, 13, 33, 30, 8, 5, True),
    (2, 25, 21, 25, 24, 12, 7, False),
    (2, 20, 6, 9, 0, 8, 3, False),
]


@pytest.mark.parametrize("m,n,d,p,bits,max_bits,pad_rows,shared_y", CASES)
def test_qgram_matches_reference(m, n, d, p, bits, max_bits, pad_rows, shared_y):
    codes, cents, y = qgram_operands(m, n, d, p, bits, max_bits=max_bits, seed=m + n,
                                     pad_rows=pad_rows, shared_y=shared_y)
    got = qgram_batched(codes, cents, y)
    assert got.shape == (m, n + pad_rows, p) and got.dtype == torch.float32
    assert not got[:, n:].any()  # -1 rows decode to 0
    xhat = decode_gathered(codes, cents).numpy()
    for i in range(m):
        yi = y.numpy() if shared_y else y[i].numpy()
        c, t = jnp.asarray(codes[i].numpy()), jnp.asarray(cents[i].numpy())
        _close(got[i], ref_qgram(c, t, jnp.asarray(yi), interpret=True), xhat[i], yi)
        _close(got[i], ref_qgram(c, t, jnp.asarray(yi)), xhat[i], yi)
        one = qgram(codes[i], cents[i], torch.from_numpy(yi))
        assert torch.equal(one, got[i])


def test_qgram_shared_y_equals_per_machine():
    codes, cents, y = qgram_operands(3, 11, 7, 5, 20, seed=4)
    per = qgram_batched(codes, cents, y.expand(3, *y.shape).contiguous())
    xhat = decode_gathered(codes, cents).numpy()
    _close(qgram_batched(codes, cents, y), per, xhat, y.numpy())


def test_qgram_unpacked_equals_packed_and_decode_then_gram():
    """The packed kernel, the unpacked one and decode-then-gram are the
    same math on the same scheme output."""
    m, n, d, p, bits = 3, 40, 12, 17, 36
    xs, tables = [], []
    rng = np.random.default_rng(17)
    for _ in range(m):
        x, edges, cents, rates = quant_operands(n, d, bits, seed=int(rng.integers(2**31)))
        xs.append(encode(x, edges))
        tables.append((cents, rates))
    C = max(c.shape[1] for c, _ in tables)
    codes = torch.stack(xs)
    cents = torch.stack([torch.nn.functional.pad(c, (0, C - c.shape[1])) for c, _ in tables])
    rates = torch.stack([r for _, r in tables])
    y = torch.from_numpy(rng.normal(size=(m, p, d)).astype(np.float32))
    unpacked = qgram_batched(codes, cents, y)
    words = TS.pack_codes(codes, rates, total_bits=bits)
    packed = qgram_packed_batched(words, rates, cents, y, total_bits=bits)
    xhat = torch.stack([decode(codes[i], cents[i]) for i in range(m)])
    twostep = torch.stack([gram(xhat[i], y[i]) for i in range(m)])
    _close(unpacked, packed, xhat.numpy(), y.numpy())
    _close(unpacked, twostep, xhat.numpy(), y.numpy())


def test_cpu_dispatch_and_launch_counts():
    assert runtime.choose("qgram", torch.zeros(1)) is qgram_plain
    runtime.reset_launches()
    codes, cents, y = qgram_operands(2, 9, 4, 3, 8, pad_rows=2)
    qgram_batched(codes, cents, y)
    assert runtime.launches()["qgram"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        qgram_cuda(codes, cents, y)
