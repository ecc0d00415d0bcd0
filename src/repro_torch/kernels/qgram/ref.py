"""Plain PyTorch versions of the fused dequantize+gram kernels —
counterpart of ``repro/kernels/qgram/ref.py``: decode and multiply (and,
for the packed path, unpack) as separate steps, every intermediate
materialized.  The oracles the kernels are held against on the card, and
what the wrappers run for CPU tensors."""
import torch

from ...core import torch_scheme


def decode_gathered(codes, scaled_cents):
    """x̂[..., j] = scaled_cents[..., j, code]; a code outside [0, C) — the
    -1 pad sentinel among them — decodes to 0, as the TPU kernels' one-hot
    does (and, for -1, the reference's ``_qgram_xla``)."""
    C = scaled_cents.shape[-1]
    inside = (codes >= 0) & (codes < C)
    idx = torch.where(inside, codes, torch.zeros_like(codes)).long()
    table = scaled_cents.unsqueeze(-3).expand(*codes.shape, C)
    xhat = torch.gather(table, -1, idx[..., None])[..., 0]
    return torch.where(inside, xhat, torch.zeros_like(xhat))


def qgram_plain(codes, scaled_cents, y):
    """codes (m, n, d) integer (-1 rows decode to 0); scaled_cents
    (m, d, C); y (p, d) shared or (m, p, d) -> (m, n, p) fp32."""
    xhat = decode_gathered(codes, scaled_cents.float())
    return xhat @ y.float().transpose(-1, -2)


def qgram_packed_plain(words, rates, scaled_cents, y, *, total_bits, mask=None, plan=None):
    """words (m, n, W) int32 bit patterns; rates (m, d); scaled_cents
    (m, d, C); y (p, d) shared or (m, p, d); mask (m, n) or None ->
    (m, n, p) fp32.  ``plan`` is the kernel's and is ignored here: the
    plain version has no tile."""
    codes = torch_scheme.unpack_codes(words, rates, total_bits=total_bits)
    xhat = decode_gathered(codes, scaled_cents.float())
    if mask is not None:
        xhat = xhat * mask.float()[..., None]
    return xhat @ y.float().transpose(-1, -2)
