"""Operand sets for holding the ``decode_attn`` kernel against its plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``),
drawn on ``device`` from a seed.

``ring`` fills the cache as a ring that has wrapped: it holds positions
pos - S + 1 .. pos, the slot of a position being a random permutation (the
kernel must look at kpos only), or with ``slot_order`` the slot a ring
buffer gives it, position mod S (so a window's valid slots lie in one or
two runs and whole tiles are invalid).  Otherwise slot s holds position s,
and slots past pos are empty (-1).  ``empty_rows`` are batch rows with
every slot empty: no valid key.
"""
from __future__ import annotations

import torch

__all__ = ["decode_attn_operands"]


def decode_attn_operands(B, S, KV, G, hd, *, pos, q_dtype=torch.float32,
                         kv_dtype=torch.bfloat16, ring=False, empty_rows=(), seed=0,
                         device=None, slot_order=False):
    """(q (B, KV, G, hd), K, V (B, S, KV, hd), kpos (B, S) int32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g, device=device)
    q = r(B, KV, G, hd).to(q_dtype)
    K = r(B, S, KV, hd).to(kv_dtype)
    V = r(B, S, KV, hd).to(kv_dtype)
    if ring and slot_order:
        held = torch.arange(pos - S + 1, pos + 1, device=device)
        kpos = torch.empty_like(held)
        kpos[held % S] = held
        kpos = kpos.expand(B, S).clone()
    elif ring:
        held = torch.arange(pos - S + 1, pos + 1, device=device)
        kpos = torch.stack([held[torch.randperm(S, generator=g, device=device)]
                            for _ in range(B)])
    else:
        kpos = torch.arange(S, device=device).expand(B, S).clone()
        kpos[kpos > pos] = -1
    kpos[list(empty_rows)] = -1
    return q, K, V, kpos.to(torch.int32).contiguous()
