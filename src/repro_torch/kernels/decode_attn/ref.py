"""Plain PyTorch version of the decode-attention kernel — counterpart of
``repro/kernels/decode_attn/ref.py::decode_attn_ref``: the oracle the kernel
is held against on the card, and what the wrapper runs for CPU tensors."""
import torch

NEG = -1e30  # the reference's finite mask value (not -inf)


def decode_attn_plain(q, K, V, kpos, pos, *, window=None, softcap=None):
    """q (B, KV, G, hd); K, V (B, S, KV, hd); kpos (B, S) integer (-1 = an
    empty slot); pos a Python int or a 0-d integer tensor; ``window`` None
    (no sliding window) or an int (0 masks every slot); ``softcap`` None or
    a float: the scores become softcap tanh(s / softcap) before the mask,
    where ``repro/models/decode.py::_attn_decode`` applies ``_softcap``.
    A slot is valid when kpos >= 0, kpos <= pos and, with a window,
    kpos > pos - window; invalid slots score NEG, so a row with no valid
    slot returns the mean of V over the S slots.  Returns the normalized
    output (B, KV, G, hd) fp32."""
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), K.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        valid &= kpos > pos - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    w = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskh->bkgh", w, V.float())
