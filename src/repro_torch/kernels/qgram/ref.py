"""Plain PyTorch version of the ``qgram_packed`` kernel — counterpart of
``repro/kernels/qgram/ref.py::qgram_packed_ref``: unpack, decode and
multiply as three steps, every intermediate materialized.  The oracle the
kernel is held against on the card, and what the wrapper runs for CPU
tensors."""
import torch

from ...core import torch_scheme


def decode_gathered(codes, scaled_cents):
    """x̂[..., j] = scaled_cents[..., j, code]; a code outside the table
    decodes to 0 (as the TPU kernel's one-hot does)."""
    C = scaled_cents.shape[-1]
    inside = codes < C
    idx = torch.where(inside, codes, torch.zeros_like(codes))
    table = scaled_cents.unsqueeze(-3).expand(*codes.shape, C)
    xhat = torch.gather(table, -1, idx[..., None])[..., 0]
    return torch.where(inside, xhat, torch.zeros_like(xhat))


def qgram_packed_plain(words, rates, scaled_cents, y, *, total_bits, mask=None):
    """words (m, n, W) int32 bit patterns; rates (m, d); scaled_cents
    (m, d, C); y (p, d) shared or (m, p, d); mask (m, n) or None ->
    (m, n, p) fp32."""
    codes = torch_scheme.unpack_codes(words, rates, total_bits=total_bits)
    xhat = decode_gathered(codes, scaled_cents.float())
    if mask is not None:
        xhat = xhat * mask.float()[..., None]
    return xhat @ y.float().transpose(-1, -2)
