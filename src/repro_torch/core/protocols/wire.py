"""Wire schemes — counterpart of ``repro/core/protocols/wire.py``.

This slice ports ``per_symbol`` (§4.2): the decorrelating transform, greedy
Algorithm-1 bit allocation and integer codes packed into the word plane,
for every machine at once.  Fault injection (slice 4), the ``vq`` channel
(slice 6) and the mesh substrate (slice 7) come later.
"""
from __future__ import annotations

import torch

from ...comm.accounting import (
    integrity_bits_formula, payload_bits_formula, row_bits, wire_bits_formula,
)
from .. import torch_scheme
from ..registry import SchemeSpec, register_scheme
from .base import PaddedShards, WireRun, WireState

__all__ = ["_run_wire_protocol", "PER_SYMBOL"]


def _run_wire_protocol(X, mask, total_bits: int, max_bits: int, mode: str,
                       center: int) -> WireState:
    """Fit + encode + decode for EVERY machine, batched over the leading
    machine axis: one batched eigh pair, one quantize, one dequantize; the
    codes leave PACKED (padded rows are all-zero words).

    mode="center": every machine targets the center's covariance (§5.1);
    mode="broadcast": machine j targets the sum of the others' (§5.2)."""
    m, n_pad, d = X.shape
    n = torch.clamp(mask.sum(dim=1), min=1.0)
    S = torch.einsum("mnd,mne->mde", X, X) / n[:, None, None]  # padded rows are 0
    if mode == "center":
        Qy = S[center].expand(m, d, d)
    elif mode == "broadcast":
        Qy = S.sum(dim=0)[None] - S
    else:
        raise ValueError(f"unknown wire mode {mode!r}")
    cap = torch_scheme.codebook_cap(total_bits, max_bits)
    tables = torch_scheme.scheme_tables(total_bits, max_bits, X.device)
    states = torch_scheme.fit_scheme_batched(S, Qy, total_bits, cap)
    codes = torch_scheme.encode(states, X, tables)
    decoded = torch_scheme.decode(states, codes, tables) * mask[..., None]
    words = torch_scheme.pack_codes(
        codes, states["rates"], total_bits=row_bits(total_bits, d, max_bits),
        mask=mask,
    )
    cents = torch_scheme.scaled_centroids(states, tables)
    return WireState(
        words, decoded, states["T_inv"], states["rates"], states["sigma"],
        cents, states["T"],
    )


def _per_symbol_run(shards: PaddedShards, bits: int, max_bits: int, mode: str,
                    center: int) -> WireRun:
    m, n_pad, d = shards.X.shape
    skip = center if mode == "center" else None
    ws = _run_wire_protocol(shards.X, shards.mask, bits, max_bits, mode, center)
    wire = wire_bits_formula(ws.rates.cpu().numpy(), shards.lengths, d, skip=skip)
    payload = payload_bits_formula(shards.lengths, d, bits, max_bits, skip=skip)
    integrity = integrity_bits_formula(shards.lengths, skip=skip)
    return WireRun(ws, int(wire), int(payload), int(integrity), shards)


PER_SYMBOL = register_scheme(SchemeSpec(name="per_symbol", run=_per_symbol_run))
