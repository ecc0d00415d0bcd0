"""The per-symbol scheme (§4.2) as tensor ops — counterpart of
``repro/core/jax_scheme.py`` (renamed: ``core/schemes.py`` is the reference's
host-side scheme classes).

* the decorrelating transform from two symmetric eigendecompositions,
* Algorithm-1 greedy bit allocation as a loop over ``total_bits`` argmax
  steps over a leading machine axis (``torch.argmax`` returns the first
  maximum, as ``jnp.argmax`` does),
* quantize/dequantize with rate-indexed padded codebook tables,
* the packed code plane: b-bit codes <-> 32-bit words, and a per-row
  CRC-16 over them.

The word plane.  PyTorch on the CPU implements no shifts for ``uint32``, so
the port holds packed words as ``int32`` tensors carrying the uint32 bit
pattern and does its bit arithmetic in ``int64`` masked to 32 bits.  The
checkpoint views the plane as ``np.uint32``, so its bytes are the
reference's.  Layout (docs/wire_format.md): the d codes of a row are
concatenated LSB-first at their widths — dimension i occupies bits
[sum(w[:i]), sum(w[:i]) + w[i]) of the row's bit stream, bit b of which is
bit b % 32 of word b // 32; pad bits are zero, width-0 dimensions occupy
nothing and unpack to code 0.

Scheme state is a dict of tensors with a leading machine axis:
``T`` (m, d, d), ``T_inv`` (m, d, d), ``sigma`` (m, d), ``rates`` (m, d)
int32.  The eigenvector signs that ``torch.linalg.eigh`` picks differ from
``jnp.linalg.eigh``'s, so ``T``/``T_inv`` (and the codes) of a fit match the
reference only up to the sign of each decorrelated dimension; the rates, the
ledgers and the reconstruction do not depend on those signs.
"""
from __future__ import annotations

import torch

from . import quantizers as Q
from .linalg_safe import eigh_sym

__all__ = [
    "WORD_BITS",
    "fit_scheme",
    "fit_scheme_batched",
    "codebook_cap",
    "scheme_tables",
    "scaled_centroids",
    "scaled_centroids_batched",
    "encode",
    "decode",
    "row_words",
    "pack_codes",
    "unpack_codes",
    "crc_words",
    "words_to_uint32",
    "words_from_uint32",
]

WORD_BITS = 32
_MASK32 = 0xFFFFFFFF


def _unit_distortion_table(max_bits: int, device) -> torch.Tensor:
    return torch.tensor(
        [Q.unit_distortion(r) for r in range(max_bits + 2)],
        dtype=torch.float32, device=device,
    )


def _sqrt_psd(M):
    """(M^{1/2}, M^{-1/2}) of a batch of PSD matrices (pseudo-inverse on the
    numerically zero eigenvalues)."""
    w, v = eigh_sym(M)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    big = s > 1e-12 * s.max(dim=-1, keepdim=True).values
    inv_s = torch.where(big, 1.0 / torch.where(s == 0, torch.ones_like(s), s),
                        torch.zeros_like(s))
    vt = v.transpose(-1, -2)
    return (v * s[..., None, :]) @ vt, (v * inv_s[..., None, :]) @ vt


def fit_scheme_batched(Qxs, Qys, total_bits: int, max_bits: int = 8) -> dict:
    """Scheme state for every machine: Qxs, Qys (m, d, d) -> dict(T, T_inv,
    sigma, rates) with a leading machine axis."""
    Qy_half, Qy_inv_half = _sqrt_psd(Qys.float())
    B = Qy_half @ Qxs.float() @ Qy_half
    lam, U = eigh_sym(0.5 * (B + B.transpose(-1, -2)))
    lam = torch.clamp(torch.flip(lam, (-1,)), min=0.0)  # descending
    U = torch.flip(U, (-1,))
    T = U.transpose(-1, -2) @ Qy_half
    T_inv = Qy_inv_half @ U

    e_tab = _unit_distortion_table(max_bits, lam.device)
    rates = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    neg_inf = torch.tensor(float("-inf"), device=lam.device)
    for _ in range(int(total_bits)):
        e_cur = e_tab[rates]
        e_nxt = e_tab[torch.clamp(rates + 1, max=max_bits + 1)]
        gain = torch.where(rates >= max_bits, neg_inf, lam * (e_cur - e_nxt))
        j = torch.argmax(gain, dim=-1, keepdim=True)
        # no dimension gains anything (all capped, or only zero-variance
        # dims left): stop allocating, as the host heap's early exit does
        step = (torch.gather(gain, -1, j) > 0.0).to(torch.int64)
        rates = rates.scatter_add(-1, j, step)
    return {"T": T, "T_inv": T_inv, "sigma": torch.sqrt(lam),
            "rates": rates.to(torch.int32)}


def fit_scheme(Qx, Qy, total_bits: int, max_bits: int = 8) -> dict:
    """:func:`fit_scheme_batched` for one machine: Qx, Qy (d, d)."""
    state = fit_scheme_batched(Qx[None], Qy[None], total_bits, max_bits)
    return {k: v[0] for k, v in state.items()}


def codebook_cap(total_bits: int, max_bits: int) -> int:
    """Largest rate any dimension can be allocated:
    ``min(max_bits, total_bits)``, which sizes the codebook tables."""
    return max(min(max_bits, total_bits), 0)


def scheme_tables(total_bits: int, max_bits: int, device=None):
    """Codebook tables sized to the largest allocatable rate."""
    return Q.build_codebook_tables(codebook_cap(total_bits, max_bits), device)


def scaled_centroids_batched(rates, sigma, tables):
    """Each dimension's centroid row at its rate, scaled by its sigma:
    rates, sigma (..., d) -> (..., d, C), the table the qgram kernel
    gathers from."""
    _, cents = tables
    return cents[rates.long()] * sigma[..., None]


def scaled_centroids(state, tables):
    return scaled_centroids_batched(state["rates"], state["sigma"], tables)


def encode(state, X, tables):
    """X (..., n, d) -> int32 codes (..., n, d) under ``state`` (whose
    leading axes match X's)."""
    edges, _ = tables
    Xp = X.float() @ state["T"].transpose(-1, -2)
    return Q.quantize(Xp, state["sigma"], state["rates"], edges)


def decode(state, codes, tables):
    """Codes (..., n, d) -> reconstructions X̂ (..., n, d)."""
    _, cents = tables
    Xp = Q.dequantize(codes, state["sigma"], state["rates"], cents)
    return Xp @ state["T_inv"].transpose(-1, -2)


# --------------------------------------------------------------------------
# the packed code plane
# --------------------------------------------------------------------------


def row_words(total_bits: int) -> int:
    """32-bit words per packed row of ``total_bits`` payload bits."""
    return (int(total_bits) + WORD_BITS - 1) // WORD_BITS


def words_to_uint32(words: torch.Tensor):
    """The int32 word plane as the reference's ``np.uint32`` array (same
    bytes)."""
    return words.detach().cpu().contiguous().numpy().view("uint32")


def words_from_uint32(arr, device=None) -> torch.Tensor:
    """A ``np.uint32`` word plane as the port's int32 tensor (same bytes)."""
    import numpy as np

    plane = np.array(arr, dtype=np.uint32, copy=True).view(np.int32)
    return torch.from_numpy(plane).to(device)


def _to_int32_bits(v64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(v64 >= 2**31, v64 - 2**32, v64).to(torch.int32)


def _layout(widths, codes_shape, device, total_bits):
    """(w, offs, W): int64 per-dimension widths and bit offsets broadcast to
    ``codes_shape``, and the words per row.  ``widths`` is a python int
    (uniform b-bit codes, b in 0..32) or an integer tensor (..., d) whose
    leading axes broadcast against the codes' (e.g. per-machine rates);
    then ``total_bits``, an upper bound on a row's width sum, sizes W."""
    d = codes_shape[-1]
    if isinstance(widths, int):
        if not 0 <= widths <= WORD_BITS:
            raise ValueError(f"uniform code width must be in 0..32, got {widths}")
        if d * widths >= 2**31:
            raise ValueError(
                f"packed row of {d * widths} bits overflows 32-bit offsets — "
                "split into multiple rows"
            )
        w = torch.full((d,), widths, dtype=torch.int64, device=device)
        total = d * widths
    else:
        w = widths.to(device=device, dtype=torch.int64)
        if w.shape[-1] != d:
            raise ValueError(f"widths must end in ({d},), got {tuple(w.shape)}")
        if total_bits is None:
            raise ValueError(
                "per-dimension widths need a total_bits bound to size the "
                "word buffer"
            )
        total = int(total_bits)
    offs = torch.cumsum(w, -1) - w  # exclusive prefix sum
    if w.dim() > 1 and len(codes_shape) > w.dim():
        w, offs = w.unsqueeze(-2), offs.unsqueeze(-2)  # over the row axis
    return w.expand(codes_shape), offs.expand(codes_shape), row_words(total)


def _width_mask(w):
    """(1 << w) - 1, exact for w == 32 too."""
    one = torch.ones_like(w)
    low = torch.bitwise_left_shift(one, torch.clamp(w, max=WORD_BITS - 1)) - 1
    return torch.where(w >= WORD_BITS, torch.full_like(w, _MASK32), low)


def pack_codes(codes, widths, *, total_bits=None, mask=None):
    """Pack integer codes along the last axis into 32-bit words.

    codes (..., d); dimension i holds values in [0, 2^widths[i]).  Negative
    entries (the -1 padded-row sentinel) pack as 0.  ``mask`` (...,) marks
    valid rows; invalid rows pack to all-zero words.  Returns (..., W)
    int32 carrying the uint32 words, W = ceil(total / 32)."""
    codes = torch.as_tensor(codes)
    shape = tuple(codes.shape)
    w, offs, W = _layout(widths, shape, codes.device, total_bits)
    c = codes.to(torch.int64)
    valid = c >= 0
    if mask is not None:
        valid = valid & (torch.as_tensor(mask, device=codes.device) > 0)[..., None]
    c = torch.where(valid, c, torch.zeros_like(c)) & _width_mask(w)
    word = offs // WORD_BITS
    bit = offs % WORD_BITS
    lo = (c << bit) & _MASK32
    # bits past the end of word `word` spill into word + 1; nothing spills
    # when bit == 0 (and a shift by 32 is avoided)
    hi = torch.where(bit > 0, c >> (WORD_BITS - torch.clamp(bit, min=1)),
                     torch.zeros_like(c))
    # disjoint bit fields: adding never carries, so add == bitwise or.  One
    # spare word takes `word + 1` of the last dimension (whose spill is 0);
    # the clamp covers width-0 codes that start at the row's end
    out = torch.zeros(shape[:-1] + (W + 1,), dtype=torch.int64, device=codes.device)
    out = out.scatter_add(-1, word, lo)
    out = out.scatter_add(-1, torch.clamp(word + 1, max=W), hi)
    return _to_int32_bits(out[..., :W])


def unpack_codes(words, widths, *, num=None, total_bits=None, mask=None):
    """Inverse of :func:`pack_codes`: (..., W) words -> (..., d) int64 codes.

    ``num`` (codes per row) is needed for a uniform int width and inferred
    from a widths tensor otherwise.  ``mask`` (...,) turns invalid rows into
    the -1 sentinel."""
    words = torch.as_tensor(words)
    if isinstance(widths, int):
        if num is None:
            raise ValueError("uniform-width unpack needs num (codes per row)")
    else:
        num = widths.shape[-1] if num is None else num
    shape = tuple(words.shape[:-1]) + (num,)
    w, offs, W = _layout(widths, shape, words.device, total_bits)
    if words.shape[-1] != W:
        raise ValueError(
            f"expected {W} words per row for this layout, got {words.shape[-1]}"
        )
    if W == 0:  # zero-rate rows: every width is 0, every code is 0
        out = torch.zeros(shape, dtype=torch.int64, device=words.device)
    else:
        w64 = words.to(torch.int64) & _MASK32
        word = offs // WORD_BITS
        bit = offs % WORD_BITS
        # the clamps keep the gathers in range for codes ending at the
        # buffer's edge (and width-0 codes past it); the width mask then
        # drops whatever they read
        lo = torch.gather(w64, -1, torch.clamp(word, max=W - 1)) >> bit
        hi_src = torch.gather(w64, -1, torch.clamp(word + 1, max=W - 1))
        hi = torch.where(
            bit > 0, (hi_src << (WORD_BITS - torch.clamp(bit, min=1))) & _MASK32,
            torch.zeros_like(hi_src),
        )
        out = (lo | hi) & _width_mask(w)
    if mask is not None:
        valid = (torch.as_tensor(mask, device=words.device) > 0)[..., None]
        out = torch.where(valid, out, torch.full_like(out, -1))
    return out


_CRC16_POLY = 0x1021  # CRC-16-CCITT
_CRC16_INIT = 0xFFFF


def crc_words(words, mask=None):
    """Per-row CRC-16-CCITT over packed words, bit-serial LSB-first over the
    row's W*32-bit stream (the order the bits occupy the wire).  ``mask``
    rows that are invalid checksum to 0; W == 0 rows checksum to the init
    value.  Returns (...,) int64 in [0, 2^16)."""
    words = torch.as_tensor(words)
    w64 = words.to(torch.int64) & _MASK32
    crc = torch.full(words.shape[:-1], _CRC16_INIT, dtype=torch.int64,
                     device=words.device)
    for i in range(words.shape[-1]):
        wd = w64[..., i]
        for b in range(WORD_BITS):
            fb = ((crc >> 15) ^ (wd >> b)) & 1
            crc = ((crc << 1) & 0xFFFF) ^ (fb * _CRC16_POLY)
    if mask is not None:
        valid = torch.as_tensor(mask, device=words.device) > 0
        crc = torch.where(valid, crc, torch.zeros_like(crc))
    return crc
