"""Plain PyTorch versions of the per-symbol quantizer kernels — counterpart
of ``repro/kernels/quant/ref.py``: the oracles the kernels are held against
on the card, and what the wrappers run for CPU tensors."""
import torch


def encode_plain(x: torch.Tensor, scaled_edges: torch.Tensor) -> torch.Tensor:
    """code[i, j] = #{e in scaled_edges[j, :] : x[i, j] > e} as int32 — a
    count with a strict ``>``, as ``encode_ref``: +inf pads never count, a
    NaN symbol counts nothing, +inf counts every finite edge.
    x (n, d) fp32, scaled_edges (d, E) fp32 -> (n, d) int32."""
    return (x.float()[:, :, None] > scaled_edges.float()[None, :, :]).sum(
        -1, dtype=torch.int32)


def decode_plain(codes: torch.Tensor, scaled_cents: torch.Tensor) -> torch.Tensor:
    """x̂[i, j] = scaled_cents[j, code[i, j]]; a code outside [0, C) — the
    -1 pad sentinel among them — decodes to 0, as the TPU kernel's one-hot
    contraction does.  (The reference's ``decode_ref`` and its XLA fallback
    index with jnp semantics instead, so there -1 wraps to the last column
    and a code >= C clamps to it.)  codes (n, d) int, scaled_cents (d, C)
    fp32 -> (n, d) fp32."""
    C = scaled_cents.shape[-1]
    inside = (codes >= 0) & (codes < C)
    idx = torch.where(inside, codes, torch.zeros_like(codes)).long()
    xhat = torch.gather(scaled_cents.float(), 1, idx.T).T
    return torch.where(inside, xhat, torch.zeros_like(xhat))
